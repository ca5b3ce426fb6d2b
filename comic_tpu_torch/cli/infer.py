"""Inference CLI: config reload, checkpoint sweep, metric scoring;
counterpart of comic_tpu/cli/infer.py (reference src/infer.py:23-138).

    python -m comic_tpu_torch.cli.infer --infer_checkpoints_dir <experiment> \
        --annotations_file <COCO annotations JSON>

Loads the experiment's config.pkl, overrides it with the flags (the same
names, defaults and choices as comic_tpu's), enumerates the compact
checkpoints (natural order, the last 12 when more than 20 exist),
captions the infer set on the CUDA card and scores each checkpoint on the
host. METEOR and SPICE run when Java and the jars (``--jar_dir``) are
there. A launch with ``COMIC_COORDINATOR`` set is refused.
"""

from __future__ import annotations

import argparse
from typing import Tuple

from .. import DeviceLike
from ..configuration import Config, load_config
from ..inference import sweep_checkpoints
from ..parallel.distributed import maybe_initialize_distributed


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--infer_checkpoints_dir", type=str, required=True,
                   help="Experiment dir containing config.pkl + ckpts.")
    p.add_argument("--infer_checkpoints", type=str, default="all",
                   help="'all' or comma-separated checkpoint numbers "
                        "(infer.py:37-38).")
    p.add_argument("--dataset_dir", type=str, default=None)
    # type=bool keeps the reference's argparse quirk (any non-empty string
    # is truthy); pass an empty string to disable
    p.add_argument("--run_inference", type=bool, default=True,
                   help="Whether to generate captions (infer.py:46-47).")
    p.add_argument("--get_metric_score", type=bool, default=True,
                   help="Whether to compute metric scores (infer.py:49-50).")
    p.add_argument("--save_attention_maps", type=bool, default=False,
                   help="Pickle attention maps per run (infer.py:52-53; "
                        "cap via config.infer_attention_max_images).")
    p.add_argument("--annotations_file", type=str, default=None,
                   help="COCO-format annotation JSON for scoring.")
    p.add_argument("--infer_set", type=str, default="test",
                   choices=["test", "valid", "coco_test", "coco_valid"])
    p.add_argument("--batch_size_infer", type=int, default=25)
    p.add_argument("--infer_beam_size", type=int, default=3)
    p.add_argument("--infer_length_penalty_weight", type=float, default=0.0)
    p.add_argument("--infer_max_length", type=int, default=30)
    p.add_argument("--infer_early_exit", type=int, default=1,
                   help="1 (default): stop decoding when every beam has "
                        "emitted EOS; 0: fixed-length decode (e.g. for "
                        "step-time profiling). Output-identical.")
    p.add_argument("--packed_dataset", type=str, default="",
                   help="Path to a packed HDF5 dataset (prepro "
                        "serialise_everything). Images are served from the "
                        "pack's pre-decoded array instead of per-file JPEG "
                        "decode.")
    p.add_argument("--jar_dir", type=str, default="",
                   help="Directory with METEOR/SPICE/CoreNLP jars.")
    # type=int (0/1), not the type=bool quirk: bool('False') is True, and
    # an explicit '--require_ptb_jar False' must mean off
    p.add_argument("--require_ptb_jar", type=int, default=0,
                   help="1: refuse to score through the Python "
                        "PTB-tokenizer fallback (set for reference-parity "
                        "runs; tokenizer skew can exceed the parity "
                        "budget).")
    return p


def infer_config(argv=None, device: DeviceLike = None
                 ) -> Tuple[argparse.Namespace, Config]:
    """The parsed command line -> (args, the Config the sweep runs with):
    the experiment's saved record with the flags applied; the COCO server
    split forces the eval batch of 61 (reference manager:64-80)."""
    args = create_parser().parse_args(argv)
    # joins the job under COMIC_COORDINATOR, as comic_tpu does; the sweep
    # then refuses a multi-process job before touching anything
    maybe_initialize_distributed(device=device)
    config = load_config(args.infer_checkpoints_dir)
    config.update(
        log_path=args.infer_checkpoints_dir,
        infer_set=args.infer_set,
        batch_size_infer=args.batch_size_infer,
        infer_beam_size=args.infer_beam_size,
        infer_length_penalty_weight=args.infer_length_penalty_weight,
        infer_max_length=args.infer_max_length,
        infer_early_exit=bool(args.infer_early_exit),
    )
    if args.dataset_dir:
        config.dataset_dir = args.dataset_dir
    if args.packed_dataset:
        config.packed_dataset = args.packed_dataset
    if args.infer_set == "coco_valid":
        config.batch_size_infer = 61
    return args, config


def main(argv=None, device: DeviceLike = None):
    """Sweep the experiment's checkpoints on ``device`` (None: the card; a
    caller may ask for the CPU) and print one ``name: k=v`` line of scores
    per checkpoint."""
    args, config = infer_config(argv, device)
    results = sweep_checkpoints(config, args.annotations_file, args.jar_dir,
                                checkpoints=args.infer_checkpoints,
                                run_infer=bool(args.run_inference),
                                get_metric_score=bool(args.get_metric_score),
                                save_attention=bool(args.save_attention_maps),
                                require_ptb_jar=bool(args.require_ptb_jar),
                                device=device)
    for name, scores in results.items():
        line = "  ".join(f"{k}={v:.4f}" for k, v in sorted(scores.items()))
        print(f"{name}: {line}")
    return results


if __name__ == "__main__":
    main()
