"""Training CLI: flag surface, stage chaining, experiment-dir naming;
counterpart of comic_tpu/cli/train.py (reference src/train.py:25-312).

    python -m comic_tpu_torch.cli.train --dataset_dir ... [--train_mode ...]

Same flag names, defaults and choices as comic_tpu, the legacy-mode
overrides (:178-200), per-run RNG seeds (:202-207), the experiment-dir
naming ``{token}_{align}_{prob}_h{heads}_{proj}_{name}_run_{NN}``
(:241-253) and the stage chain: ``decoder`` trains from a pretrained CNN
with the CNN frozen; ``cnn_finetune`` restores the decoder run (lr 1e-3,
10 epochs, nothing frozen); ``scst`` restores the cnn_finetune run (batch
10, beam ``--scst_beam_size``, lr 1e-3, 10 epochs, the CNN frozen) into
``{name}_cnnFT_SCST_beam_{K}_CrD_{w}_B1_{b1}_B4_{b4}_run_{NN}``.
``--cnn_ckpt_path`` points at the pretrained CNN: a converted encoder
checkpoint (msgpack, e.g. from utils/net_params.maybe_get_ckpt_file) or a
slim TF ImageNet checkpoint, converted in memory (TensorFlow needed);
without one the CNN trains from random init, with a warning. Training runs
on the CUDA card, in one process: a launch with ``COMIC_COORDINATOR`` set
is refused.
"""

from __future__ import annotations

import argparse
import functools
import os
import traceback
from typing import Callable, Tuple

from .. import DeviceLike
from ..configuration import RUN_SEEDS, Config, load_config
from ..parallel.distributed import maybe_initialize_distributed
from ..parallel.mesh import barrier
from ..training.scst import train_fn_scst
from ..training.xe import train_fn

pjoin = os.path.join


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", type=str, default="lstm")
    p.add_argument("--dataset_dir", type=str, default="")
    p.add_argument("--dataset_file_pattern", type=str,
                   default="mscoco_{}_w5_s20_include_restval")
    p.add_argument("--train_mode", type=str, default="decoder",
                   choices=["decoder", "cnn_finetune", "scst"])
    p.add_argument("--legacy", action="store_true")
    p.add_argument("--token_type", type=str, default="radix",
                   choices=["radix", "word", "char"])
    p.add_argument("--radix_base", type=int, default=256)
    p.add_argument("--cnn_name", type=str, default="inception_v1")
    p.add_argument("--cnn_input_size", type=str, default="224,224")
    # type=bool flags keep the reference's argparse quirk: ANY non-empty
    # string is truthy, pass an empty string '' to disable
    p.add_argument("--cnn_input_augment", type=bool, default=True)
    p.add_argument("--cnn_fm_attention", type=str, default="Mixed_4f")
    p.add_argument("--cnn_fm_projection", type=str, default="tied",
                   choices=["none", "independent", "tied"])
    p.add_argument("--rnn_name", type=str, default="LSTM",
                   choices=["LSTM", "LN_LSTM", "GRU"])
    p.add_argument("--rnn_size", type=int, default=512)
    p.add_argument("--rnn_word_size", type=int, default=256)
    p.add_argument("--rnn_init_method", type=str, default="first_input",
                   choices=["project_hidden", "first_input"])
    p.add_argument("--rnn_recurr_dropout", type=bool, default=False)
    p.add_argument("--attn_num_heads", type=int, default=8)
    p.add_argument("--attn_context_layer", type=bool, default=False)
    p.add_argument("--attn_alignment_method", type=str, default="add_LN",
                   choices=["add_LN", "add", "dot"])
    p.add_argument("--attn_probability_fn", type=str, default="softmax",
                   choices=["softmax", "sigmoid"])
    p.add_argument("--attn_keep_prob", type=float, default=0.9)
    p.add_argument("--initialiser", type=str, default="xavier",
                   choices=["xavier", "he", "none"])
    p.add_argument("--optimiser", type=str, default="adam",
                   choices=["adam", "sgd"])
    p.add_argument("--batch_size_train", type=int, default=32)
    p.add_argument("--batch_size_eval", type=int, default=61)
    p.add_argument("--max_epoch", type=int, default=30)
    p.add_argument("--lr_start", type=float, default=1e-2)
    p.add_argument("--lr_end", type=float, default=1e-5)
    p.add_argument("--cnn_grad_multiplier", type=float, default=1.0)
    p.add_argument("--adam_epsilon", type=float, default=1e-2)
    p.add_argument("--scst_beam_size", type=int, default=7)
    p.add_argument("--scst_weight_ciderD", type=float, default=1.0)
    p.add_argument("--scst_weight_bleu", type=str, default="0,0,0,2")
    p.add_argument("--freeze_scopes", type=str, default="encoder/cnn")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--checkpoint_exclude_scopes", type=str, default="")
    p.add_argument("--cnn_ckpt_path", type=str, default=None,
                   help="Pretrained CNN checkpoint: converted (msgpack) "
                        "or a slim TF checkpoint (needs TensorFlow).")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--run", type=int, default=1)
    p.add_argument("--log_root", type=str, default=None,
                   help="Experiment root (default <repo>/experiments).")
    p.add_argument("--num_data_shards", type=int, default=0,
                   help="Kept for config compatibility with comic_tpu; "
                        "the port trains on one card.")
    p.add_argument("--train_steps_per_call", type=int, default=1,
                   help="XE train steps between two log/save checks.")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace dir (captures a few train "
                        "iterations for the TensorBoard trace viewer).")
    return p


def apply_legacy_overrides(args: argparse.Namespace) -> None:
    """Paper-setting overrides (src/train.py:178-200)."""
    args.cnn_name = "inception_v1"
    args.cnn_input_size = "224,224"
    args.cnn_input_augment = True
    args.cnn_fm_attention = "Mixed_4f"
    args.rnn_name = "LSTM"
    args.rnn_size = 512
    args.rnn_word_size = 256
    args.rnn_init_method = "project_hidden"
    args.rnn_recurr_dropout = False
    args.attn_context_layer = False
    args.attn_alignment_method = "add_LN"
    args.attn_probability_fn = "softmax"
    args.attn_keep_prob = 1.0
    args.lr_start = 1e-3
    args.lr_end = 2e-4
    args.lr_reduce_every_n_epochs = 4
    args.cnn_grad_multiplier = 1.0
    args.initialiser = "xavier"
    args.optimiser = "adam"
    args.batch_size_train = 32
    args.adam_epsilon = 1e-6


def experiment_name(args: argparse.Namespace) -> str:
    """``{token}_{align}_{prob}_h{heads}_{proj3}_{name}`` (:241-253)."""
    token = (f"radix_b{args.radix_base}" if args.token_type == "radix"
             else args.token_type)
    name = "_".join([
        token, args.attn_alignment_method, args.attn_probability_fn,
        f"h{args.attn_num_heads}", str(args.cnn_fm_projection)[:3],
        args.name,
    ])
    if args.legacy:
        name = "legacy_" + name
    return name


def resolve_stage(args: argparse.Namespace) -> dict:
    """Stage chaining: dirs, restore sources, per-stage overrides
    (:233-270). Returns extra config kwargs including log_path and the
    stage's training function (``stage_fn``)."""
    dataset = args.dataset_file_pattern.split("_")[0]
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    log_root = args.log_root or pjoin(repo_root, "experiments", dataset)
    if not args.dataset_dir:
        args.dataset_dir = pjoin(repo_root, "datasets", dataset)

    name = experiment_name(args)
    dec_dir = pjoin(log_root, f"{name}_run_{args.run:02d}")
    cnnft_dir = pjoin(log_root, f"{name}_cnnFT_run_{args.run:02d}")

    if args.train_mode == "decoder":
        if args.freeze_scopes not in ("encoder/cnn", "Model/encoder/cnn"):
            raise ValueError("decoder stage expects the CNN frozen")
        if args.checkpoint_path is None:
            args.checkpoint_path = args.cnn_ckpt_path
        if args.checkpoint_path is None:
            print("WARNING: no pretrained CNN checkpoint; the encoder will "
                  "train from random init (expect lower CIDEr).")
        log_path = dec_dir
        stage_fn = train_fn
    elif args.train_mode == "cnn_finetune":
        if args.legacy:
            raise NotImplementedError
        if not os.path.exists(dec_dir):
            raise ValueError(
                f"Decoder training log path not found: {dec_dir}")
        args.lr_start = 1e-3
        args.max_epoch = 10
        args.freeze_scopes = ""
        args.checkpoint_path = dec_dir
        log_path = cnnft_dir
        stage_fn = train_fn
    elif args.train_mode == "scst":
        if args.legacy:
            raise NotImplementedError
        if not os.path.exists(cnnft_dir):
            raise ValueError(
                f"CNN finetune log path not found: {cnnft_dir}")
        wb = [float(w) for w in str(args.scst_weight_bleu).split(",")]
        args.scst_weight_bleu = wb
        args.batch_size_train = 10
        args.lr_start = 1e-3
        args.max_epoch = 10
        args.freeze_scopes = "encoder/cnn"
        args.checkpoint_path = cnnft_dir
        scst = (f"beam_{args.scst_beam_size}_CrD_{args.scst_weight_ciderD}"
                f"_B1_{wb[0]}_B4_{wb[-1]}")
        log_path = pjoin(log_root,
                         f"{name}_cnnFT_SCST_{scst}_run_{args.run:02d}")
        stage_fn = train_fn_scst
    else:
        raise ValueError(args.train_mode)

    return {"log_path": log_path, "save_path": pjoin(log_path, "model"),
            "resume_training": os.path.exists(log_path),
            "stage_fn": stage_fn}


def try_to_train(stage_fn, config: Config, try_block: bool = True):
    """Error-capture wrapper (train_fn.py:341-377): writes
    error__{name}.txt with the traceback beside the log dir."""
    if not try_block:
        return stage_fn(config)
    try:
        return stage_fn(config)
    except Exception:
        name = os.path.basename(config.log_path.rstrip("/"))
        err_dir = os.path.dirname(config.log_path) or "."
        os.makedirs(err_dir, exist_ok=True)
        with open(pjoin(err_dir, f"error__{name}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def stage_config(argv=None, device: DeviceLike = None
                 ) -> Tuple[Callable, Config]:
    """The parsed command line -> (stage function, Config) as ``main``
    trains them: legacy overrides, the run's seed, the stage chain, and
    the saved experiment record when the stage's directory exists.

    With ``COMIC_COORDINATOR`` set, the process joins the data-parallel
    job right after parsing (on ``device``, None: the card), and every
    rank reads the experiment directory before any rank may write it."""
    args = create_parser().parse_args(argv)
    maybe_initialize_distributed(device=device)
    if args.legacy:
        print("LEGACY mode enabled. Some arguments will be overridden.")
        apply_legacy_overrides(args)
    if args.run not in RUN_SEEDS:
        raise ValueError(
            f"--run {args.run} has no seed in the reference's table "
            f"(runs {sorted(RUN_SEEDS)}); add a seed to RUN_SEEDS or "
            "pick a listed run.")
    rand_seed = RUN_SEEDS[args.run]
    extra = resolve_stage(args)
    stage_fn = extra.pop("stage_fn")

    kwargs = dict(vars(args))
    kwargs.pop("cnn_ckpt_path", None)
    kwargs.pop("log_root", None)
    kwargs.update(extra)
    kwargs.update(
        rnn_layers=1, dropout_rnn_in=0.35, dropout_rnn_out=0.35,
        rnn_map_loss_scale=1.0, l2_decay=1e-5, clip_gradient_norm=0,
        max_saves=12, num_logs_per_epoch=100, rand_seed=rand_seed)
    config = Config(**kwargs)
    if config.resume_training:
        # reload the saved experiment record, as the reference does
        saved = load_config(config.log_path)
        saved.update(resume_training=True, max_epoch=config.max_epoch,
                     lr_end=config.lr_end, checkpoint_path=config.log_path)
        config = saved
    config.overwrite_safety_check(overwrite=config.resume_training)
    barrier()
    return stage_fn, config


def main(argv=None, device: DeviceLike = None):
    """Train the stage the command line names on ``device`` (None: the
    card; a caller may ask for the CPU)."""
    stage_fn, config = stage_config(argv, device)
    return try_to_train(functools.partial(stage_fn, device=device), config)


if __name__ == "__main__":
    main()
