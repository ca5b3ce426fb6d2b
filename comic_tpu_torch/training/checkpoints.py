"""Checkpoints; counterpart of comic_tpu/training/checkpoints.py
(reference train_fn.py:66-70,130-132, infer.py:90-97,
model_base.py:422-490).

File contract shared with comic_tpu (flax msgpack, read and written here
by the port's own codec, tensors in comic_tpu's layout):
  - ``model-<step>.msgpack``: the full training state {"params", "step",
    "opt_state"}, the optimizer state in the layout flax writes for
    comic_tpu's optax chain; the 2 most recent are kept;
  - ``model_compact-<step>.msgpack``: the parameter tree alone; the
    ``max_saves`` (12) most recent are kept;
  - listed in natural order; inference evaluates the last 12 when more
    than 20 exist;
  - the 3-way restore: full resume / model only (minus excluded scopes) /
    CNN only into the encoder subtree.
The loaders dispatch on the artifact found on disk: a msgpack file, an
Orbax directory (``<name>.orbax/``, read with tensorstore,
``orbax_store.py``; ``make_saver("orbax")`` writes them), or a reference
TF checkpoint (``<name>.index``: a published COMIC model or a slim
ImageNet CNN, converted in memory by ``utils/tf_checkpoint.py``, which
needs TensorFlow).
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import params as bridge
from ..models.layers import tree_leaves
from ..utils.natural_sort import natural_key
from . import orbax_store
from .msgpack_codec import packb, unpackb
from .optimizer import _normalize_scopes, path_string

Params = Dict[str, Any]

FULL_PREFIX = "model-"
COMPACT_PREFIX = "model_compact-"
_SUFFIX = ".msgpack"
_ORBAX_SUFFIX = ".orbax"
_TF_SUFFIX = ".index"  # TF V2-format checkpoints (reference model_compact-N)

def list_checkpoints(directory: str, prefix: str = COMPACT_PREFIX
                     ) -> List[str]:
    """Checkpoint basenames (no suffix), natural-sorted ascending:
    msgpack files, orbax directories and reference TF checkpoints."""
    if not os.path.isdir(directory):
        return []
    pat = re.compile(re.escape(prefix) + r"\d+"
                     + f"({re.escape(_SUFFIX)}|{re.escape(_ORBAX_SUFFIX)}"
                     + f"|{re.escape(_TF_SUFFIX)})$")
    names = {f[: f.rfind(".")] for f in os.listdir(directory)
             if pat.match(f)}
    return sorted(names, key=natural_key)


def checkpoint_step(name: str) -> int:
    """The step a checkpoint name ends in (-1 when none)."""
    m = re.search(r"(\d+)$", name)
    return int(m.group(1)) if m else -1


def select_eval_checkpoints(directory: str, cap: int = 12,
                            threshold: int = 20) -> List[str]:
    """All compact checkpoints, but only the last ``cap`` when more than
    ``threshold`` exist (reference infer.py:90-97)."""
    names = list_checkpoints(directory, COMPACT_PREFIX)
    if len(names) > threshold:
        names = names[-cap:]
    return names


def _resolve(path_or_dir: str, prefix: str) -> str:
    if os.path.isfile(path_or_dir):
        return path_or_dir
    if path_or_dir.endswith(_ORBAX_SUFFIX) and os.path.isdir(path_or_dir):
        return path_or_dir
    for suffix in (_SUFFIX, _ORBAX_SUFFIX, _TF_SUFFIX):
        if os.path.exists(path_or_dir + suffix):
            return path_or_dir + suffix
    names = list_checkpoints(path_or_dir, prefix)
    if not names:
        raise FileNotFoundError(
            f"No {prefix}* checkpoints under {path_or_dir}")
    base = os.path.join(path_or_dir, names[-1])
    for suffix in (_SUFFIX, _ORBAX_SUFFIX, _TF_SUFFIX):
        if os.path.exists(base + suffix):
            return base + suffix
    return base + _ORBAX_SUFFIX


def _check_like(restored, template, path: str = "") -> None:
    """Raise unless ``restored`` has the template's keys and shapes."""
    if isinstance(template, dict):
        if not isinstance(restored, dict) or set(restored) != set(template):
            raise ValueError(
                f"checkpoint keys at '{path or '/'}' differ from the model: "
                f"{sorted(restored) if isinstance(restored, dict) else restored!r}"
                f" vs {sorted(template)}")
        for k in template:
            _check_like(restored[k], template[k], f"{path}/{k}")
    elif tuple(restored.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{tuple(restored.shape)}, the model "
                         f"{tuple(template.shape)}")


def load_compact(path_or_dir: str, template: Params) -> Params:
    """Load a compact checkpoint into the structure of ``template`` (a
    parameter tree of the port), on the template's device: a msgpack file,
    an Orbax directory, or a reference TF ``model_compact-N`` checkpoint
    (converted in memory: the parity path for published COMIC models).
    Raises ValueError when keys or shapes differ."""
    path = _resolve(path_or_dir, COMPACT_PREFIX)
    if path.endswith(_TF_SUFFIX):
        tree = _tf_reference_restore(path[: -len(_TF_SUFFIX)], template)
    elif path.endswith(_ORBAX_SUFFIX):
        tree = orbax_store.read_tree(path)
    else:
        with open(path, "rb") as f:
            tree = unpackb(f.read())
    device = tree_leaves(template)[0].device
    state = bridge.from_jax_tree(tree, device=device)
    _check_like(state, template)
    return state


def _tf_reference_restore(tf_path: str, template: Params) -> Params:
    """A reference TF model checkpoint -> the full parameter tree in
    comic_tpu's layout, keyed and shaped as ``template``."""
    from ..utils import tf_checkpoint as tfc

    if not (isinstance(template, dict) and "encoder" in template
            and "decoder" in template):
        raise ValueError(
            f"{tf_path} is a TF checkpoint, but the restore target is not "
            "a full model params tree — convert it explicitly "
            "(utils.tf_checkpoint) instead.")
    # the names alone first: a slim CNN checkpoint (no Model/ scope) goes
    # to restore_model's CNN branch without reading its tensors here
    if not any(n.startswith("Model/")
               for n in tfc.reference_checkpoint_names(tf_path)):
        raise ValueError(
            f"No `Model/` variables in {tf_path} — not a reference "
            "trained-model checkpoint.")
    return tfc.convert_reference_tree(
        tfc.load_reference_checkpoint_vars(tf_path),
        bridge.to_jax_tree(template))


def _atomic_write(path: str, data: bytes) -> None:
    """Write through a temporary name unique to this process and thread,
    then rename: a reader never sees a partial file, and two writers never
    share a temporary file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_compact(directory: str, step: int, state: Params) -> str:
    """Write ``model_compact-<step>.msgpack`` (the format comic_tpu reads)
    atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{COMPACT_PREFIX}{int(step)}{_SUFFIX}")
    _atomic_write(path, packb(bridge.to_jax_tree(state)))
    return path


def _prune(directory: str, prefix: str, keep: int) -> None:
    """Delete all but the ``keep`` most recent msgpack/orbax checkpoints of
    ``prefix``. Reference TF checkpoints in the directory take no slot and
    are never deleted."""
    ckpts = [p for p in list_checkpoints(directory, prefix)
             if os.path.exists(os.path.join(directory, p + _SUFFIX))
             or os.path.exists(os.path.join(directory, p + _ORBAX_SUFFIX))]
    for p in ckpts[:-keep] if keep > 0 else []:
        for suffix in (_SUFFIX, _ORBAX_SUFFIX):
            path = os.path.join(directory, p + suffix)
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                elif os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass


def _write_checkpoint(directory: str, step: int, params: Params,
                      opt_state: Optional[Params], max_saves: int
                      ) -> Tuple[str, str]:
    """Both files from host trees in comic_tpu's layout, then retention."""
    os.makedirs(directory, exist_ok=True)
    compact = os.path.join(directory, f"{COMPACT_PREFIX}{step}{_SUFFIX}")
    _atomic_write(compact, packb(params))
    full = os.path.join(directory, f"{FULL_PREFIX}{step}{_SUFFIX}")
    state = {"params": params, "step": np.int64(step)}
    if opt_state is not None:
        state["opt_state"] = opt_state
    _atomic_write(full, packb(state))
    _prune(directory, COMPACT_PREFIX, max_saves)
    _prune(directory, FULL_PREFIX, 2)
    return full, compact


def save_checkpoint(directory: str, step: int, params: Params,
                    opt_state: Optional[Params] = None, *,
                    max_saves: int = 12) -> Tuple[str, str]:
    """Write the full and the compact checkpoint of ``params`` (the port's
    tree) and ``opt_state`` (``Optimizer.state_dict``); returns their
    paths."""
    return _write_checkpoint(directory, int(step), bridge.to_jax_tree(params),
                             opt_state, max_saves)


class AsyncCheckpointer:
    """Background checkpoint writer: the caller pays only for the copy of
    the state to the host (synchronous, so the next step cannot change it
    under the copy); encoding, file IO and retention run on a worker
    thread. A worker's exception surfaces on the next save() or wait().
    Call close() (or wait()) before reading the files. ``write`` writes
    one pair and applies retention (msgpack files by default)."""

    def __init__(self, write=_write_checkpoint):
        self._write = write
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write(**job)
            except BaseException as e:  # surfaced on the next call
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, directory: str, step: int, params: Params,
             opt_state: Optional[Params] = None, *,
             max_saves: int = 12) -> None:
        """Copy to the host now and queue the write."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer.save() after close()")
        self._raise_pending()
        self._q.put(dict(directory=directory, step=int(step),
                         params=bridge.to_jax_tree(params),
                         opt_state=opt_state, max_saves=max_saves))

    def wait(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._closed:
            return
        self.wait()
        self._closed = True
        self._q.put(None)
        self._thread.join()


def _write_orbax_checkpoint(directory: str, step: int, params: Params,
                            opt_state: Optional[Params], max_saves: int
                            ) -> Tuple[str, str]:
    """Both checkpoints as Orbax directories, with comic_tpu's
    OrbaxCheckpointer's retention: prune first, keeping one slot for the
    pair about to land (compact max(max_saves - 1, 1), full 1)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _prune(directory, COMPACT_PREFIX, max(max_saves - 1, 1))
    _prune(directory, FULL_PREFIX, 1)
    compact = orbax_store.write_tree(os.path.join(
        directory, f"{COMPACT_PREFIX}{step}{_ORBAX_SUFFIX}"), params)
    state = {"params": params, "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = opt_state
    full = orbax_store.write_tree(os.path.join(
        directory, f"{FULL_PREFIX}{step}{_ORBAX_SUFFIX}"), state)
    return full, compact


def make_saver(backend: Optional[str] = "msgpack") -> AsyncCheckpointer:
    """Training-driver saver factory (config.checkpoint_backend): msgpack
    files, or Orbax directories (``model[_compact]-<step>.orbax/``, which
    comic_tpu's OrbaxCheckpointer reads back), both written on a worker
    thread with the same save()/wait()/close()."""
    if backend == "orbax":
        return AsyncCheckpointer(_write_orbax_checkpoint)
    if backend in ("msgpack", None, "none"):
        return AsyncCheckpointer()
    raise ValueError(f"Unknown checkpoint backend: {backend!r}")


def load_full(path_or_dir: str) -> Dict[str, Any]:
    """The decoded full checkpoint {"params", "step", "opt_state"} as host
    trees in comic_tpu's layout, from a msgpack file or an Orbax
    directory."""
    path = _resolve(path_or_dir, FULL_PREFIX)
    if path.endswith(_TF_SUFFIX):
        raise ValueError(
            f"{path} is a reference TF FULL checkpoint (graph + optimizer "
            "slots); resuming reference optimizer state is not supported. "
            "Restore the model variables from the matching model_compact-N "
            "instead (checkpoint_path without resume).")
    if path.endswith(_ORBAX_SUFFIX):
        return orbax_store.read_tree(path)
    with open(path, "rb") as f:
        return unpackb(f.read())


def restore_with_excludes(params: Params, restored: Params,
                          exclude_scopes: Optional[str]) -> Params:
    """``restored``, but ``params``' leaves where a path matches an
    excluded scope (reference filter_variables, regex search)."""
    pats = [re.compile(sc) for sc in _normalize_scopes(exclude_scopes)]
    if not pats:
        return restored

    def merge(old, new, prefix):
        if isinstance(old, dict):
            return {k: merge(old[k], new[k], prefix + (k,)) for k in old}
        s = path_string(prefix)
        return old if any(p.search(s) for p in pats) else new

    return merge(params, restored, ())


def restore_model(params: Params, checkpoint_path: Optional[str], *,
                  resume: bool = False,
                  exclude_scopes: Optional[str] = None,
                  optimizer=None) -> Tuple[Params, int, str]:
    """The reference's 3-way restore (model_base.py:422-490) into the
    structure and device of ``params``; a resume also loads the optimizer
    state into ``optimizer``. Returns (params, start_step, mode), mode one
    of 'scratch' | 'resume' | 'model' | 'cnn'."""
    if not checkpoint_path:
        return params, 0, "scratch"
    device = tree_leaves(params)[0].device

    if resume and not exclude_scopes:
        state = load_full(checkpoint_path)
        restored = bridge.from_jax_tree(state["params"], device=device)
        _check_like(restored, params)
        if optimizer is not None and "opt_state" in state:
            optimizer.load_state_dict(state["opt_state"], restored)
        return restored, int(state["step"]), "resume"

    # Resolve first, so that a reference TF model paired with the wrong
    # config fails with its converter's error, and only an artifact that is
    # not a full model goes on to the CNN branch
    resolved = None
    try:
        resolved = _resolve(checkpoint_path, COMPACT_PREFIX)
    except FileNotFoundError:
        pass
    if resolved and resolved.endswith(_TF_SUFFIX):
        from ..utils import tf_checkpoint as tfc

        tf_path = resolved[: -len(_TF_SUFFIX)]
        if any(n.startswith("Model/")
               for n in tfc.reference_checkpoint_names(tf_path)):
            # a full reference model: converter errors propagate untouched
            restored = bridge.from_jax_tree(tfc.convert_reference_tree(
                tfc.load_reference_checkpoint_vars(tf_path),
                bridge.to_jax_tree(params)), device=device)
            _check_like(restored, params)
            return (restore_with_excludes(params, restored, exclude_scopes),
                    0, "model")
        # no Model/ scope: a raw slim CNN checkpoint, the CNN branch below
    compact_err: Optional[BaseException] = None
    if resolved is not None and not resolved.endswith(_TF_SUFFIX):
        try:
            restored = load_compact(resolved, params)
            return (restore_with_excludes(params, restored, exclude_scopes),
                    0, "model")
        except ValueError as e:
            compact_err = e  # maybe a CNN-only file: the CNN branch below

    # CNN only: a converted slim checkpoint holding just the encoder/cnn
    # subtree (model_base.py:471-484), or a vanilla slim TF ImageNet
    # checkpoint converted in memory (root scope auto-detected)
    cnn_tpl = params["encoder"]["cnn"]
    path = checkpoint_path
    try:
        if os.path.isdir(path):
            cands = [f for f in os.listdir(path)
                     if f.endswith(_SUFFIX) or f.endswith(_TF_SUFFIX)]
            if not cands:
                raise FileNotFoundError(f"No checkpoint under {path}")
            path = os.path.join(path, sorted(cands, key=natural_key)[-1])
        if path.endswith(_TF_SUFFIX):
            path = path[: -len(_TF_SUFFIX)]
        if os.path.exists(path + _TF_SUFFIX):
            from ..utils import tf_checkpoint as tfc

            tpl = bridge.to_jax_tree(cnn_tpl)
            tree = tfc.convert_slim_tree(tfc._detect_cnn_tree(
                tfc.load_reference_checkpoint_vars(path), "", tpl), tpl)
        else:
            with open(path, "rb") as f:
                tree = unpackb(f.read())
        cnn = bridge.from_jax_tree(tree, device=device)
        _check_like(cnn, cnn_tpl)
    except Exception as cnn_err:
        if compact_err is not None:
            raise ValueError(
                f"Checkpoint {resolved!r} failed the full-model restore "
                f"({compact_err}) AND the CNN-only fallback ({cnn_err}). "
                "The first error is usually the real one (config/"
                "checkpoint mismatch).") from compact_err
        raise
    out = dict(params)
    out["encoder"] = dict(params["encoder"], cnn=cnn)
    # the reference's CNN branch also filters the excluded scopes
    return restore_with_excludes(params, out, exclude_scopes), 0, "cnn"


def save_cnn_checkpoint(path: str, cnn_params: Params) -> None:
    """Write an encoder-only checkpoint (the pretrained-CNN artifact)."""
    _atomic_write(path, packb(bridge.to_jax_tree(cnn_params)))
