"""SCST n-gram document-frequency cache CLI; counterpart of
comic_tpu/prepro/ngrams.py (reference common/scst/prepro_ngrams.py:24-156).

    python -m comic_tpu_torch.prepro.ngrams --dataset_dir <dir>

Reads the training caption file, groups the references per image, and
writes the ``{pattern}_scst-words.p`` pickle {document_frequency, ref_len}
that CIDEr-D reads during SCST training (train_fn.py:192-201).
"""

from __future__ import annotations

import argparse
import os

from ..data import captions as cap_io
from ..evaluation.ngrams import build_idf_cache, save_idf_cache

pjoin = os.path.join


def build_from_caption_file(dataset_dir: str, pattern: str) -> str:
    records = cap_io.read_caption_file(
        cap_io.caption_file_path(dataset_dir, pattern, "train"))
    grouped = cap_io.group_by_image(records, max_refs=10 ** 9)
    cache = build_idf_cache([refs for _, refs in grouped])
    out = pjoin(dataset_dir, "captions",
                pattern.format("scst-words") + ".p")
    save_idf_cache(out, cache)
    return out


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--dataset_file_pattern", type=str,
                   default="mscoco_{}_w5_s20_include_restval")
    return p


def main(argv=None):
    args = create_parser().parse_args(argv)
    out = build_from_caption_file(args.dataset_dir,
                                  args.dataset_file_pattern)
    print(f"INFO: wrote {out}")
    return out


if __name__ == "__main__":
    main()
