"""Experiment configuration (the port's own copy of comic_tpu.configuration).

A typed attribute bag with the reference's full flag surface and defaults
(reference src/train.py:25-164,281-302 and
reference common/configuration.py:18-59). Like the reference, the
config is the experiment record: training pickles it into the experiment
directory as ``config.pkl`` (``Config.save``, the same record comic_tpu
writes, so each package loads the other's), and inference reloads it
verbatim. Unlike the reference we keep explicit typed
defaults here instead of scattering them across argparse + kwargs.

``load_config`` can also ingest the reference's Python-2 pickles
(``encoding='latin1'``) so pretrained reference experiments can be evaluated
for parity.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

# Version of the config.pkl record; load_config migrates older ones. The
# same marker and number as comic_tpu's, so one record serves both.
CONFIG_VERSION = 2


# Defaults mirror src/train.py argparse defaults + coded kwargs (:281-302).
_DEFAULTS: Dict[str, Any] = dict(
    # naming / paths
    name="lstm",
    dataset_dir="",
    dataset_file_pattern="mscoco_{}_w5_s20_include_restval",
    log_path="",
    save_path="",
    train_mode="decoder",  # decoder | cnn_finetune | scst
    legacy=False,
    # tokens
    token_type="radix",  # radix | word | char
    radix_base=256,
    # encoder
    cnn_name="inception_v1",
    cnn_input_size=(224, 224),
    cnn_input_augment=True,
    cnn_fm_attention="Mixed_4f",
    cnn_fm_projection="tied",  # none | independent | tied
    # decoder rnn
    rnn_name="LSTM",  # LSTM | LN_LSTM | GRU
    rnn_size=512,
    rnn_word_size=256,
    rnn_init_method="first_input",  # project_hidden | first_input
    rnn_recurr_dropout=False,
    rnn_layers=1,
    dropout_rnn_in=0.35,
    dropout_rnn_out=0.35,
    rnn_map_loss_scale=1.0,
    # attention
    attn_num_heads=8,
    attn_context_layer=False,
    attn_alignment_method="add_LN",  # add_LN | dot
    attn_probability_fn="softmax",  # softmax | sigmoid
    attn_keep_prob=0.9,
    # optimization
    initialiser="xavier",
    optimiser="adam",
    batch_size_train=32,
    batch_size_eval=61,
    max_epoch=30,
    lr_start=1e-2,
    lr_end=1e-5,
    lr_reduce_every_n_epochs=4,  # legacy-mode schedule only
    cnn_grad_multiplier=1.0,
    adam_epsilon=1e-2,
    l2_decay=1e-5,
    clip_gradient_norm=0.0,
    freeze_scopes="encoder/cnn",
    # scst
    scst_beam_size=7,
    scst_weight_ciderD=1.0,
    scst_weight_bleu=(0.0, 0.0, 0.0, 2.0),
    # inference
    batch_size_infer=25,
    infer_beam_size=3,
    infer_length_penalty_weight=0.0,
    infer_max_length=30,
    infer_set="test",
    # attention-map pickle size cap (images); -1 = full run like the
    # reference (infer_fn.py:129-175)
    infer_attention_max_images=4,
    # stop decoding once every beam has emitted EOS (the reference's
    # dynamic_decode behavior). Applies only when attention maps are not
    # collected; output-identical to the full-length scan
    # (tests/test_decoding.py). Worst-case cost +0.9%; real-data serving
    # gains scale with (max_steps - longest caption in batch).
    infer_early_exit=True,
    # checkpointing / logging
    checkpoint_path=None,
    checkpoint_exclude_scopes="",
    resume_training=False,
    max_saves=12,
    checkpoint_backend="msgpack",  # or "orbax" (tensorstore dirs, async)
    num_logs_per_epoch=100,
    add_image_summaries=True,
    add_vars_summaries=False,
    add_grad_summaries=False,
    rand_seed=48964896,
    run=1,
    # framework fields with no reference equivalent (shared with comic_tpu
    # so one config.pkl drives both packages)
    compute_dtype="bfloat16",  # dtype for matmul/conv compute
    num_data_shards=0,  # cap on the data-parallel mesh size (0 = all
                        # devices that divide the batch)
    train_steps_per_call=1,  # XE steps per host dispatch (lax.scan of K)
    profile_dir=None,  # torch.profiler trace dir (3 XE train iterations
                       # from the 12th)
    scst_overlap=True,  # overlap host CIDEr scoring with the next rollout
                        # (one-step-stale sampling; False = strict
                        # on-policy reference schedule)
    # host loader: reproduce TF1 resize_bilinear (align_corners=False)
    # exactly instead of cv2 half-pixel centers (parity runs)
    host_resize_tf1=False,
    # derived during pipeline/model construction (reference mutates its
    # config the same way — manager_image_caption.py:55,104-108,132,141)
    wtoi=None,
    itow=None,
    vocab_size=None,
    split_sizes=None,
    max_step=None,
)

# run-number -> RNG seed (src/train.py:202-207)
RUN_SEEDS = {1: 48964896, 2: 88888888, 3: 123456789}


class Config:
    """Attribute-bag configuration with typed defaults.

    ``Config(**overrides)`` starts from the defaults above; unknown keys are
    accepted (the reference does the same) so older/newer config pickles
    remain loadable.
    """

    def __init__(self, **kwargs: Any):
        merged = dict(_DEFAULTS)
        merged.update(kwargs)
        # 'none' strings are coerced to None (src/train.py:277-279)
        for k, v in merged.items():
            if isinstance(v, str) and v == "none":
                merged[k] = None
        if isinstance(merged.get("cnn_input_size"), str):
            merged["cnn_input_size"] = tuple(
                int(v) for v in merged["cnn_input_size"].split(",")
            )
        self.__dict__.update(merged)

    # --- dict-ish access -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def update(self, **kwargs: Any) -> "Config":
        self.__dict__.update(kwargs)
        return self

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def __repr__(self) -> str:
        keys = sorted(self.__dict__)
        inner = ", ".join(f"{k}={self.__dict__[k]!r}" for k in keys[:8])
        return f"Config({inner}, ... {len(keys)} fields)"

    # --- persistence (reference configuration.py:28-52) -------------------
    def save(self, log_path: Optional[str] = None) -> str:
        """Write ``config___<stamp>.txt`` (human-readable) and
        ``config.pkl`` (the record inference reloads, atomically, with the
        version marker); returns the pickle's path."""
        log_path = log_path or self.log_path
        os.makedirs(log_path, exist_ok=True)
        stamp = time.strftime("%m-%d_%H-%M-%S")
        with open(os.path.join(log_path, f"config___{stamp}.txt"), "w") as f:
            for k in sorted(self.__dict__):
                if k in ("wtoi", "itow"):
                    f.write(f"{k} = <{len(self.__dict__[k] or {})} entries>\n")
                else:
                    f.write(f"{k} = {self.__dict__[k]}\n")
        pkl = os.path.join(log_path, "config.pkl")
        d = self.to_dict()
        d["_comic_tpu_config_version"] = CONFIG_VERSION
        # a crash mid-dump must not leave a truncated record that
        # overwrite_safety_check would then refuse to replace
        tmp = f"{pkl}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(d, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, pkl)
        return pkl

    def overwrite_safety_check(self, overwrite: bool) -> None:
        """Refuse to clobber an existing experiment unless resuming
        (reference configuration.py:38-47)."""
        exists = os.path.exists(os.path.join(self.log_path, "config.pkl"))
        if exists and not (overwrite or self.resume_training):
            raise FileExistsError(
                f"Experiment dir already has a config.pkl: {self.log_path}. "
                "Pass resume/overwrite to proceed.")


def load_config(path: str) -> Config:
    """Load a ``config.pkl`` written by this framework or by the TF1
    reference (Python-2 pickle -> latin1 decode)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.pkl")
    with open(path, "rb") as f:
        try:
            d = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            d = pickle.load(f, encoding="latin1")
    if not isinstance(d, dict):  # reference pickles the Config instance dict
        d = d.__dict__
    d = dict(d)
    # records without the version marker (v1, incl. reference config.pkls)
    # predate the change of a default's meaning below
    version = d.pop("_comic_tpu_config_version", 1)
    # Migration (v1 records only): num_data_shards defaulted to the inert
    # value 1 before it was wired as a mesh-size cap (0 = uncapped).
    # Old config.pkl files carry 1, which would now silently serialize
    # onto one device — treat the old default as unset. Records written
    # by current code carry the version marker, so a DELIBERATE cap of 1
    # survives.
    if version < 2 and d.get("num_data_shards") == 1:
        print("NOTE: config.pkl predates the num_data_shards version "
              "marker; treating num_data_shards=1 (the old inert default) "
              "as 0 (uncapped). Set it to 1 again after loading if the "
              "single-shard cap was deliberate.")
        d["num_data_shards"] = 0
    return Config(**d)
