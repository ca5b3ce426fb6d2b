"""TF-slim and reference COMIC TF1 checkpoints -> parameter trees;
counterpart of comic_tpu/utils/tf_checkpoint.py.

The reference initializes its encoder from vanilla slim ImageNet
checkpoints by stripping the scope prefix (model_base.py:471-484, registry
at common/net_params.py:19-106), and publishes trained COMIC models as TF1
checkpoints under the ``Model/`` scope (train_fn.py:66-70). This module
reads both (TF1 V1/V2 format via ``tf.train.load_checkpoint``; TensorFlow
is imported only by the functions that read files) and converts them in
comic_tpu's numpy tree layout: slim names below the root scope, conv
kernels HWIO as slim stores them. The result crosses into the port's
layout only through the weight bridge (``comic_tpu_torch/params.py``), as
every other restore does.

Variable name contract (slim), e.g.:
  InceptionV1/<Block>[/Branch_i/<Conv>]/weights
  InceptionV1/.../BatchNorm/{beta,moving_mean,moving_variance[,gamma]}
  resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/{weights,BatchNorm/...}
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np

from .optional import require


def _tf():
    return require("tensorflow", "Reading a TF checkpoint")


# encoder name -> slim root scope (common/nets/*.py arg_scopes)
ROOT_SCOPES: Dict[str, str] = {
    "inception_v1": "InceptionV1",
    "inception_v2": "InceptionV2",
    "inception_v3": "InceptionV3",
    "inception_v4": "InceptionV4",
    "inception_resnet_v2": "InceptionResnetV2",
    "resnet_v1_50": "resnet_v1_50",
    "resnet_v1_101": "resnet_v1_101",
    "resnet_v1_152": "resnet_v1_152",
    "resnet_v2_50": "resnet_v2_50",
    "resnet_v2_101": "resnet_v2_101",
    "resnet_v2_152": "resnet_v2_152",
    "vgg_16": "vgg_16",
    "vgg_19": "vgg_19",
    "mobilenet_v1": "MobilenetV1",
    "mobilenet_v2": "MobilenetV2",
    "mobilenet_v2_140": "MobilenetV2",
    # nasnet/pnasnet checkpoints carry NO root scope (slim builds them
    # without an outer variable_scope: cell_stem_0/..., conv0/...)
    "nasnet_mobile": "",
    "nasnet_large": "",
    "pnasnet_mobile": "",
    "pnasnet_large": "",
}

# classifier / aux-head scopes dropped during conversion — every encoder is
# built num_classes=None (model_base.py:72-76 uses features only)
_DROP_SCOPES = frozenset({
    "Logits", "AuxLogits", "logits", "predictions", "Predictions",
    "fc8",          # vgg classifier
    "Conv2d_1c_1x1",  # mobilenet_v1 classifier conv lives under Logits; kept
                      # here defensively for flat exports
    "final_layer",  # nasnet/pnasnet classifier head (nasnet.py _build_nasnet)
})


def _dropped_scope(first_part: str) -> bool:
    # aux towers (nasnet aux_7/aux_11/..., nasnet.py aux head scopes)
    return first_part in _DROP_SCOPES or first_part.startswith("aux_")


def _walk_set(tree: Dict[str, Any], parts, value) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def slim_reader_to_tree(name_to_array: Dict[str, np.ndarray],
                        root_scope: str = "InceptionV1") -> Dict[str, Any]:
    """{var name: array} -> nested param dict matching the encoder's
    init_params tree (root scope stripped, classifier heads dropped)."""
    tree: Dict[str, Any] = {}
    prefix = root_scope + "/" if root_scope else ""
    for name, arr in name_to_array.items():
        if not name.startswith(prefix):
            continue
        parts = name[len(prefix):].split("/")
        if _dropped_scope(parts[0]):
            continue
        _walk_set(tree, parts, np.asarray(arr))
    return tree


def load_slim_checkpoint(ckpt_path: str, root_scope: str = "InceptionV1"
                         ) -> Dict[str, Any]:
    """Read a TF checkpoint from disk (requires tensorflow)."""
    reader = _tf().train.load_checkpoint(ckpt_path)
    shapes = reader.get_variable_to_shape_map()
    # skip optimizer slots via the shared leaf-suffix rule (_is_slot_var):
    # a substring test would also drop a legitimate scope that merely
    # CONTAINS 'adam'/'momentum' somewhere in its path
    arrays = {name: reader.get_tensor(name) for name in shapes
              if not _is_slot_var(name)}
    return slim_reader_to_tree(arrays, root_scope)


def _has_leaves(tree: Any) -> bool:
    if not isinstance(tree, dict):
        return True
    return any(_has_leaves(v) for v in tree.values())


def verify_tree_shapes(converted: Dict[str, Any],
                       template: Dict[str, Any], path: str = "") -> None:
    """Raise if the converted tree is missing leaves or has shape drift.

    Template subtrees with no leaves (e.g. inception v3/v4 pool branches,
    which hold no parameters) have no checkpoint variables and are skipped.
    """
    for k, tpl in template.items():
        sub = f"{path}/{k}" if path else k
        if isinstance(tpl, dict) and not _has_leaves(tpl):
            continue
        if k not in converted:
            raise KeyError(f"Missing converted variable subtree: {sub}")
        if isinstance(tpl, dict):
            verify_tree_shapes(converted[k], tpl, sub)
        else:
            got = np.asarray(converted[k])
            if tuple(got.shape) != tuple(tpl.shape):
                raise ValueError(
                    f"Shape mismatch at {sub}: ckpt {got.shape} vs "
                    f"model {tuple(tpl.shape)}")


def _flatten_leaves(tree: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, Any]:
    """{'a': {'b': x}} -> {'a/b': x}. Keys that already contain '/'
    (nasnet's compound scope-path leaf keys) join transparently."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_leaves(v, name))
        else:
            out[name] = v
    return out


def convert_slim_tree(converted: Dict[str, Any], template: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Shape-verify and re-key a stripped slim tree onto the template's
    treedef (guarantees an identical pytree structure for restore).

    Matching is on slash-joined flat names, so the two sides may nest
    differently (nasnet/pnasnet param stores keep compound keys like
    'separable_5x5_1/depthwise_weights' as single leaves while checkpoint
    names split on every '/')."""
    flat_src = _flatten_leaves(converted)
    flat_tpl = _flatten_leaves(template)
    missing = sorted(k for k in flat_tpl if k not in flat_src)
    if missing:
        raise KeyError(
            f"Missing converted variable(s): {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}")
    for k, tpl in flat_tpl.items():
        got = np.asarray(flat_src[k])
        if tuple(got.shape) != tuple(np.shape(tpl)):
            raise ValueError(
                f"Shape mismatch at {k}: ckpt {got.shape} vs "
                f"model {tuple(np.shape(tpl))}")

    def merge(tpl, path):
        if isinstance(tpl, dict):
            # leafless template subtrees (pool branches) stay empty
            return {k: merge(tpl[k], f"{path}/{k}" if path else k)
                    for k in tpl}
        return np.asarray(flat_src[path], dtype=np.float32)

    return merge(template, "")


def _strip_prefix_tree(name_to_array: Dict[str, np.ndarray], prefix: str,
                       root_scope: str) -> Dict[str, Any]:
    """Strip `prefix` then the slim root scope (may be '' — nasnet/pnasnet
    checkpoints carry no root scope) and nest into a param tree."""
    inner = {name[len(prefix):]: arr for name, arr in name_to_array.items()
             if name.startswith(prefix)}
    return slim_reader_to_tree(inner, root_scope)


def _sorted_tree(tree):
    """Keys in sorted order at every level, as comic_tpu's files hold them
    (jax rebuilds every dict it maps over in sorted key order)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def convert_slim_checkpoint(ckpt_path: str, out_path: str,
                            cnn_name: str = "inception_v1") -> str:
    """slim checkpoint -> encoder-only msgpack checkpoint (the pretrained-
    CNN artifact the decoder stage restores in mode 'cnn'). The template is
    this package's encoder, in comic_tpu's layout through the bridge."""
    import torch

    from .. import params as bridge
    from ..models.encoders import get_encoder
    from ..training.checkpoints import save_cnn_checkpoint

    root_scope = ROOT_SCOPES.get(cnn_name)
    if root_scope is None:
        raise ValueError(f"No converter wiring for {cnn_name}; "
                         f"known: {sorted(ROOT_SCOPES)}")
    spec = get_encoder(cnn_name)
    template = bridge.to_jax_tree(spec.init(torch.Generator().manual_seed(0)))
    converted = load_slim_checkpoint(ckpt_path, root_scope)
    out = convert_slim_tree(converted, template)
    save_cnn_checkpoint(out_path,
                        bridge.from_jax_tree(_sorted_tree(out), device="cpu"))
    return out_path


# --------------------------------------------------------------------------
# Reference trained-model checkpoints (model_compact-N / model-N)
# --------------------------------------------------------------------------
#
# The reference saves whole trained models as TF1 checkpoints holding every
# variable under the `Model/` scope (train_fn.py:66-70: the compact saver's
# var_list is GLOBAL_VARIABLES filtered by 'Model'); published pretrained
# COMIC models ship in this format (README.md:22-23). Variable names follow
# the TF1 variable_scope chain of the train graph (model.py:50-55 Model /
# encoder / decoder; model_base.py:109-184 rnn_decoder; ops_rnn.py contrib
# layer scopes):
#
#   Model/encoder/cnn/<SlimScope>/...            CNN (slim layout, §above)
#   Model/encoder/LN_tanh/{beta,gamma}           legacy head only
#   Model/encoder/im_embed/weight                legacy head only
#   Model/decoder/rnn_decoder/embedding_map                     (S, W)
#   Model/decoder/rnn_decoder/output_projection/{kernel,bias}
#   Model/decoder/rnn_decoder/memory_layer/kernel               (C, U)
#   Model/decoder/rnn_decoder/value_layer/kernel                [independent]
#   Model/decoder/rnn_decoder/rnn_init_input/projection/weight  [first_input]
#   Model/decoder/rnn_decoder/rnn_init_input/basic_lstm_cell/{kernel,bias}
#       (the cell's FIRST call happens inside the rnn_init_input scope,
#        model_base.py:673-685, so TF1's RNNCell scope caching places the
#        fused kernel there)
#   Model/decoder/rnn_decoder/rnn_initial_state/weight          [project_hidden]
#   Model/decoder/rnn_decoder/decoder/multi_head_attention_wrapper_v3/
#       multi_add_attention/query_layer/kernel                  (U, U)
#       multi_add_attention/attention_v                         (U,)
#       multi_add_attention/LN_tanh/{beta,gamma}                [add_LN]
#       ... /softmax_temperature                                scalar
#       ... /a_layer/kernel                                     [context layer]
#       (created lazily at the wrapper's first __call__ inside
#        dynamic_decode's default 'decoder' scope, ops_rnn.py:523-565,
#        735-739)
#
# Because the deep chain depends on contrib Layer auto-naming internals
# (and duplicate eval-graph scopes like 'decoder_1' can exist in the same
# checkpoint), the converter matches each decoder variable by its
# UNAMBIGUOUS NAME SUFFIX under `Model/decoder/` rather than the full path,
# preferring non-uniquified scopes when duplicates exist.
#
# Validation status: the `variable_scope(None, default_name=...)`
# uniquification that produces the eval-graph '..._1' duplicates was
# verified empirically under tf.compat.v1 (second open of the same
# default-named scope yields 'multi_add_attention_1'); the leaf suffixes
# themselves come from the reference/contrib sources cited above (Dense
# layer names, BasicLSTMCell/GRUCell variable names, ops.linear 'weight',
# contrib layer_norm 'gamma'/'beta'). The full TF1 Layer scope-capture
# machinery is no longer runnable here (Keras 3 removed v1.layers /
# rnn_cell) — the suffix matcher exists precisely so conversion does not
# depend on the unverifiable part of the chain, and every mismatch fails
# loudly (missing-suffix KeyError / shape ValueError).

_SLOT_NAMES = frozenset({"adam", "momentum", "rmsprop", "ema",
                         "exponentialmovingaverage"})
_GLOBAL_SLOTS = frozenset({"global_step", "beta1_power", "beta2_power",
                           "learning_rate"})


def _is_slot_var(name: str) -> bool:
    """Optimizer-slot / training-bookkeeping variables (Saver slots are
    named `<var>/Adam`, `<var>/Adam_1`, `<var>/Momentum`, ...)."""
    last = name.rsplit("/", 1)[-1].lower()
    if last in _GLOBAL_SLOTS:
        return True
    return re.sub(r"_\d+$", "", last) in _SLOT_NAMES


_CNN_PREFIX = "Model/encoder/cnn/"

# contrib-cell variable layouts -> comic_tpu cell param keys
# (gate orders already match: BasicLSTMCell i,j,f,o — models/cells.py:44;
#  GRUCell r,u gates + candidate — models/cells.py:101)
_CELL_SUFFIXES = {
    "LSTM": [
        ("basic_lstm_cell/kernel", ("cell", "kernel")),
        ("basic_lstm_cell/bias", ("cell", "bias")),
    ],
    "GRU": [
        ("gru_cell/gates/kernel", ("cell", "gate_kernel")),
        ("gru_cell/gates/bias", ("cell", "gate_bias")),
        ("gru_cell/candidate/kernel", ("cell", "cand_kernel")),
        ("gru_cell/candidate/bias", ("cell", "cand_bias")),
    ],
    # contrib LayerNormBasicLSTMCell: per-gate norms named
    # input/transform/forget/output/state (contrib rnn_cell LN cell)
    "LN_LSTM": [
        ("layer_norm_basic_lstm_cell/kernel", ("cell", "kernel")),
    ] + [
        (f"layer_norm_basic_lstm_cell/{tf_gate}/{tf_p}",
         ("cell", our_gate, our_p))
        for tf_gate, our_gate in [("input", "ln_i"), ("transform", "ln_j"),
                                  ("forget", "ln_f"), ("output", "ln_o"),
                                  ("state", "ln_c")]
        for tf_p, our_p in [("gamma", "scale"), ("beta", "bias")]
    ],
}


def _tree_get(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def decoder_suffix_map(decoder_template: Dict[str, Any]):
    """(name suffix under Model/decoder/) -> comic_tpu decoder param path,
    derived from which optional leaves the template contains."""
    pairs = [
        ("embedding_map", ("embedding",)),
        ("output_projection/kernel", ("output_projection", "kernel")),
        ("output_projection/bias", ("output_projection", "bias")),
        ("memory_layer/kernel", ("attention", "memory_layer", "kernel")),
        ("query_layer/kernel", ("attention", "query_layer", "kernel")),
    ]
    attn = decoder_template.get("attention", {})
    if "v" in attn:
        pairs.append(("attention_v", ("attention", "v")))
    if "ln" in attn:
        pairs += [("LN_tanh/gamma", ("attention", "ln", "scale")),
                  ("LN_tanh/beta", ("attention", "ln", "bias"))]
    if "softmax_temperature" in attn:
        pairs.append(("softmax_temperature",
                      ("attention", "softmax_temperature")))
    if "value_layer" in attn:
        pairs.append(("value_layer/kernel",
                      ("attention", "value_layer", "kernel")))
    if "a_layer" in attn:
        pairs.append(("a_layer/kernel", ("attention", "a_layer", "kernel")))
    if "rnn_init_input" in decoder_template:
        pairs.append(("rnn_init_input/projection/weight",
                      ("rnn_init_input", "kernel")))
    if "rnn_initial_state" in decoder_template:
        pairs.append(("rnn_initial_state/weight",
                      ("rnn_initial_state", "kernel")))
    cell = decoder_template.get("cell", {})
    if "gate_kernel" in cell:
        pairs += _CELL_SUFFIXES["GRU"]
    elif "ln_i" in cell:
        pairs += _CELL_SUFFIXES["LN_LSTM"]
    else:
        pairs += _CELL_SUFFIXES["LSTM"]
    return pairs


_UNIQ_SEG = re.compile(r"_\d+$")


def _dup_scope_rank(name: str) -> int:
    """Number of TF-uniquified ('scope_1') segments — eval/SCST graphs
    re-open default-named scopes, duplicating variables; prefer the
    train-graph originals (rank 0)."""
    return sum(1 for seg in name.split("/") if _UNIQ_SEG.search(seg))


def _pick_by_suffix(names, suffix: str) -> Optional[str]:
    cands = [n for n in names
             if n.endswith("/" + suffix) or n == suffix]
    if not cands:
        return None
    cands.sort(key=lambda n: (_dup_scope_rank(n), len(n), n))
    best = cands[0]
    # Every same-uniquification-rank candidate is ambiguous — a shorter
    # path must not silently win over a longer one sharing the suffix
    # (that could mask a genuine collision in an unusual checkpoint).
    ties = [n for n in cands[1:]
            if _dup_scope_rank(n) == _dup_scope_rank(best)]
    if ties:
        raise ValueError(
            f"Ambiguous checkpoint variables for suffix {suffix!r}: "
            f"{[best] + ties}")
    return best


def _detect_cnn_tree(name_to_array: Dict[str, np.ndarray], prefix: str,
                     template_cnn: Dict[str, Any]) -> Dict[str, Any]:
    """Strip `prefix` and auto-detect whether a slim root scope follows
    (InceptionV1/..., resnet_v1_50/...) or not (nasnet/pnasnet variables
    are rootless: cell_stem_0/..., conv0/...), by matching the template's
    top-level keys."""
    tree0 = _strip_prefix_tree(name_to_array, prefix, "")
    if not tree0:
        raise ValueError(f"No CNN variables under {prefix!r}")
    tpl_flat = set(_flatten_leaves(template_cnn))
    if set(_flatten_leaves(tree0)) & tpl_flat:
        return tree0
    if len(tree0) == 1:
        (root, sub), = tree0.items()
        if isinstance(sub, dict) and set(_flatten_leaves(sub)) & tpl_flat:
            return sub
    raise ValueError(
        f"CNN variables under {prefix!r} (top scopes {sorted(tree0)[:4]}...)"
        f" do not match the model's encoder tree")


def convert_reference_tree(name_to_array: Dict[str, np.ndarray],
                           template_params: Dict[str, Any],
                           cnn_name: Optional[str] = None) -> Dict[str, Any]:
    """{TF var name: array} from a reference Model checkpoint -> full
    comic_tpu params pytree {encoder, decoder} matching `template_params`.

    With `cnn_name=None` the slim root scope is auto-detected against the
    template. Raises KeyError/ValueError on missing variables or shape
    drift so a wrong model/config pairing fails loudly.
    """
    model_vars = {n: a for n, a in name_to_array.items()
                  if n.startswith("Model/") and not _is_slot_var(n)}
    if not model_vars:
        raise ValueError("No `Model/` variables found — not a reference "
                         "trained-model checkpoint?")

    # --- encoder ---
    if cnn_name is None:
        cnn_tree = _detect_cnn_tree(model_vars, _CNN_PREFIX,
                                    template_params["encoder"]["cnn"])
    else:
        root_scope = ROOT_SCOPES.get(cnn_name)
        if root_scope is None:
            raise ValueError(f"No converter wiring for {cnn_name}; "
                             f"known: {sorted(ROOT_SCOPES)}")
        cnn_tree = _strip_prefix_tree(model_vars, _CNN_PREFIX, root_scope)
    encoder = {"cnn": convert_slim_tree(cnn_tree,
                                        template_params["encoder"]["cnn"])}
    enc_tpl = template_params["encoder"]
    if "LN_tanh" in enc_tpl:  # legacy head (model_base.py:80-91)
        encoder["LN_tanh"] = {
            "scale": np.asarray(model_vars["Model/encoder/LN_tanh/gamma"],
                                np.float32),
            "bias": np.asarray(model_vars["Model/encoder/LN_tanh/beta"],
                               np.float32)}
        encoder["im_embed"] = {
            "kernel": np.asarray(model_vars["Model/encoder/im_embed/weight"],
                                 np.float32)}

    # --- decoder (suffix matched under Model/decoder/) ---
    dec_tpl = template_params["decoder"]
    dec_names = [n for n in model_vars if n.startswith("Model/decoder/")]
    decoder: Dict[str, Any] = {}
    consumed = set()
    for suffix, path in decoder_suffix_map(dec_tpl):
        name = _pick_by_suffix(dec_names, suffix)
        if name is None:
            raise KeyError(
                f"Reference checkpoint is missing a decoder variable with "
                f"suffix {suffix!r} (wanted for param {'/'.join(path)})")
        arr = np.asarray(model_vars[name], np.float32)
        tpl_leaf = _tree_get(dec_tpl, path)
        if tpl_leaf is None:
            raise KeyError(f"Template has no decoder param {'/'.join(path)}")
        if tuple(arr.shape) != tuple(np.shape(tpl_leaf)):
            raise ValueError(
                f"Shape mismatch for {name} -> {'/'.join(path)}: "
                f"ckpt {arr.shape} vs model {tuple(np.shape(tpl_leaf))}")
        _walk_set(decoder, list(path), arr)
        consumed.add(name)

    leftovers = sorted(n for n in dec_names if n not in consumed
                       and _dup_scope_rank(n) == 0)
    if leftovers:
        print("WARNING: unconsumed reference decoder variables (ignored): "
              f"{leftovers}")

    # re-key onto the template treedef (identical pytree structure)
    def merge(tpl, conv, path=""):
        if isinstance(tpl, dict):
            return {k: merge(tpl[k], conv.get(k, {}), f"{path}/{k}")
                    for k in tpl}
        arr = np.asarray(conv, dtype=np.float32)
        tpl_shape = tuple(np.shape(tpl))
        # Only the scalar-vs-(1,)/() normalization may reshape; any other
        # size-equal mismatch (e.g. a transposed kernel) must fail loudly
        # instead of being silently reinterpreted.
        if tuple(arr.shape) != tpl_shape and arr.size != 1:
            raise ValueError(
                f"Shape mismatch for converted param {path}: "
                f"ckpt {tuple(arr.shape)} vs model {tpl_shape}")
        return arr.reshape(tpl_shape)

    return {"encoder": merge(enc_tpl, encoder, "encoder"),
            "decoder": merge(dec_tpl, decoder, "decoder")}


def reference_checkpoint_names(ckpt_path: str) -> list:
    """Variable names only, no tensor read (a cheap probe)."""
    reader = _tf().train.load_checkpoint(ckpt_path)
    return list(reader.get_variable_to_shape_map())


def load_reference_checkpoint_vars(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every non-slot variable of a TF checkpoint (requires tensorflow)."""
    reader = _tf().train.load_checkpoint(ckpt_path)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()
            if not _is_slot_var(name)}


def convert_reference_checkpoint(ckpt_path: str, config, vocab,
                                 out_path: Optional[str] = None) -> str:
    """Reference ``model_compact-N`` TF checkpoint -> compact msgpack
    checkpoint holding the full model parameters, byte for byte the file
    comic_tpu writes. ``config``/``vocab`` define the template (normally the
    experiment directory's config.pkl, the pairing the reference's infer.py
    relies on, infer.py:106-107)."""
    from .. import params as bridge
    from ..models.captioner import build_model_spec, init_params
    from ..training.checkpoints import COMPACT_PREFIX, _SUFFIX, _atomic_write
    from ..training.msgpack_codec import packb

    spec = build_model_spec(config, vocab)
    template = bridge.to_jax_tree(init_params(spec, device="cpu"))
    converted = convert_reference_tree(
        load_reference_checkpoint_vars(ckpt_path), template, spec.cnn_name)
    if out_path is None:
        base = os.path.basename(ckpt_path)
        step = base.rsplit("-", 1)[-1] if "-" in base else "0"
        out_path = os.path.join(os.path.dirname(ckpt_path) or ".",
                                f"{COMPACT_PREFIX}{step}{_SUFFIX}")
    _atomic_write(out_path, packb(_sorted_tree(converted)))
    return out_path
