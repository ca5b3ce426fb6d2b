"""MS-COCO dataset preparation CLI; counterpart of comic_tpu/prepro/coco.py
(reference datasets/preprocessing/coco_prepro.py:50-199).

    python -m comic_tpu_torch.prepro.coco --dataset_dir <dir>

Reads the Karpathy split JSON (dataset_coco.json) and writes the caption
txts, vocabulary JSONs, filename lists and COCO-format annotation JSONs
under ``<dir>/captions/`` with the reference's default artifact suffix
``w5_s20_include_restval``. The reference also downloads the Karpathy zip
and the COCO image zips; here the inputs must already be on disk.
"""

from __future__ import annotations

import argparse
import os

from . import base

pjoin = os.path.join


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", type=str, required=True,
                   help="Dir containing dataset_coco.json and image dirs.")
    p.add_argument("--karpathy_json", type=str, default="dataset_coco.json")
    p.add_argument("--output_prefix", type=str, default="mscoco")
    p.add_argument("--word_count_thres", type=int, default=5)
    p.add_argument("--caption_len_thres", type=int, default=20)
    # type=bool mirrors the reference's argparse quirk (coco_prepro.py:36):
    # ANY non-empty value — including 'False'/'0' — is truthy; pass an
    # empty string ('--include_restval=') to disable restval.
    p.add_argument("--include_restval", type=bool, default=True)
    return p


def main(argv=None):
    args = create_parser().parse_args(argv)
    suffix = "w{}_s{}{}".format(
        args.word_count_thres, args.caption_len_thres,
        "_include_restval" if args.include_restval else "")
    prefix = f"{args.output_prefix}_{{}}_{suffix}"

    dataset = base.tokenise_karpathy(
        pjoin(args.dataset_dir, args.karpathy_json))
    out_dir = pjoin(args.dataset_dir, "captions")
    counts = base.write_caption_txts(
        dataset, out_dir, prefix,
        caption_len_thres=args.caption_len_thres,
        include_restval=args.include_restval)
    vocab = base.write_vocab(
        dataset, out_dir, prefix,
        word_count_thres=args.word_count_thres,
        caption_len_thres=args.caption_len_thres,
        include_restval=args.include_restval)
    base.write_filename_lists(dataset, out_dir, args.include_restval)
    base.write_annotation_jsons(dataset, out_dir,
                                include_restval=args.include_restval)
    print(f"INFO: splits {counts}, vocab {len(vocab)} entries")
    return counts, vocab


if __name__ == "__main__":
    main()
