"""One-command reference-parity gate for the port; counterpart of
tools/parity_gate.py, with the same flags, verdict and exit codes.

    python -m comic_tpu_torch.tools.parity_gate \
        --experiment_dir /path/to/reference_experiment \
        --dataset_dir    /path/to/coco_dataset \
        --annotations_file /path/to/captions_annotations.json \
        --target_cider <the published CIDEr of this config> \
        --jar_dir /path/to/jars      # CoreNLP/METEOR/SPICE

Chain: config.pkl ingestion (py2 pickle ok) -> TF `model_compact-N`
checkpoints converted on load (msgpack read as it is) -> the beam-search
sweep on the card (comic_tpu_torch.inference.sweep_checkpoints; its
attention steps are the kernel K1, or K2 at --infer_beam_size 1) -> COCO
metric scoring (CoreNLP PTB tokenization REQUIRED by default: the Python
fallback is refused, because tokenizer skew can exceed the parity budget;
pass --allow_ptb_fallback for rehearsals) -> CIDEr gate:

    PASS  iff  max over checkpoints of CIDEr >= target * (1 - tolerance)

with tolerance defaulting to 0.5% (the parity budget). Exits 0 on PASS,
1 on FAIL, and prints one machine-readable JSON line either way.
``--device cpu`` runs the sweep on the CPU instead of the card.
"""

from __future__ import annotations

import argparse
import json
import sys


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment_dir", type=str, required=True,
                   help="Reference experiment dir: config.pkl + "
                        "model_compact-N checkpoints (TF or msgpack).")
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--annotations_file", type=str, required=True,
                   help="COCO-format annotation JSON for the scored split.")
    p.add_argument("--target_cider", type=float, required=True,
                   help="Published reference CIDEr for this config.")
    p.add_argument("--tolerance", type=float, default=0.005,
                   help="Relative parity budget (default 0.5%%).")
    p.add_argument("--infer_set", type=str, default="test",
                   choices=["test", "valid", "coco_test", "coco_valid"])
    p.add_argument("--infer_checkpoints", type=str, default="all")
    p.add_argument("--batch_size_infer", type=int, default=None,
                   help="Override config's inference batch.")
    p.add_argument("--infer_beam_size", type=int, default=None)
    p.add_argument("--infer_max_length", type=int, default=None)
    p.add_argument("--jar_dir", type=str, default="")
    p.add_argument("--allow_ptb_fallback", action="store_true",
                   help="Score through the Python PTB tokenizer when no "
                        "jar is available. Rehearsals only: the resulting "
                        "numbers are NOT parity evidence.")
    p.add_argument("--device", type=str, default=None,
                   help="Where the sweep decodes (default: the card; "
                        "'cpu' runs it on the CPU).")
    return p


def run(args) -> dict:
    from ..configuration import load_config
    from ..inference import sweep_checkpoints

    config = load_config(args.experiment_dir)
    config.update(log_path=args.experiment_dir, infer_set=args.infer_set)
    if args.dataset_dir:
        config.dataset_dir = args.dataset_dir
    for name in ("batch_size_infer", "infer_beam_size", "infer_max_length"):
        val = getattr(args, name)
        if val is not None:
            setattr(config, name, val)
    if args.infer_set == "coco_valid":  # forced server-split batch
        config.batch_size_infer = 61

    results = sweep_checkpoints(
        config, annotations_file=args.annotations_file,
        jar_dir=args.jar_dir, checkpoints=args.infer_checkpoints,
        require_ptb_jar=not args.allow_ptb_fallback, device=args.device)
    if not results:
        raise RuntimeError("No checkpoint produced scores — nothing to "
                           "gate (check --infer_checkpoints and the "
                           "experiment dir).")
    per_ckpt = {name: scores.get("CIDEr") for name, scores in results.items()}
    missing = [n for n, c in per_ckpt.items() if c is None]
    if missing:
        raise RuntimeError(f"CIDEr missing from scores for {missing}")
    best_name = max(per_ckpt, key=per_ckpt.get)
    best = float(per_ckpt[best_name])
    threshold = args.target_cider * (1.0 - args.tolerance)
    return {
        "passed": bool(best >= threshold),
        "best_checkpoint": best_name,
        "best_cider": best,
        "target_cider": args.target_cider,
        "tolerance": args.tolerance,
        "threshold": threshold,
        "tokenizer": "corenlp_jar" if not args.allow_ptb_fallback
                     else "python_fallback_allowed",
        "per_checkpoint_cider": per_ckpt,
    }


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    verdict = run(args)
    print(json.dumps(verdict))
    print(f"PARITY {'PASS' if verdict['passed'] else 'FAIL'}: best CIDEr "
          f"{verdict['best_cider']:.4f} ({verdict['best_checkpoint']}) vs "
          f"threshold {verdict['threshold']:.4f} "
          f"(target {verdict['target_cider']:.4f} - "
          f"{verdict['tolerance']:.1%})")
    return 0 if verdict["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
