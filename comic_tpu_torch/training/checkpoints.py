"""Compact checkpoints; counterpart of the compact-file part of
comic_tpu/training/checkpoints.py.

File contract shared with comic_tpu: ``model_compact-<step>.msgpack`` holds
the model parameter tree (flax msgpack, read and written here by the port's
own codec), listed in natural order; inference evaluates the last 12 when
more than 20 exist (reference infer.py:90-97). Orbax directories and
reference TF checkpoints are recognized on disk but their restores are not
yet ported. Full (optimizer) checkpoints come with the training slice.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List

from .. import params as bridge
from .msgpack_codec import packb, unpackb

Params = Dict[str, Any]

FULL_PREFIX = "model-"
COMPACT_PREFIX = "model_compact-"
_SUFFIX = ".msgpack"
_ORBAX_SUFFIX = ".orbax"
_TF_SUFFIX = ".index"  # TF V2-format checkpoints (reference model_compact-N)

_DIGITS = re.compile(r"(\d+)")


def _natural_key(s: str):
    """Human-order sort key: digit runs compare numerically."""
    return [int(part) if part.isdigit() else part.lower()
            for part in _DIGITS.split(str(s))]


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
    return sorted(names, key=_natural_key)


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
    """Load a compact msgpack checkpoint into the structure of
    ``template`` (a parameter tree of the port), on the template's device.
    Raises ValueError when keys or shapes differ."""
    path = _resolve(path_or_dir, COMPACT_PREFIX)
    if path.endswith(_TF_SUFFIX) or path.endswith(_ORBAX_SUFFIX):
        raise NotImplementedError(
            f"{path}: restoring TF-format and Orbax checkpoints is not yet "
            "ported to comic_tpu_torch; convert it to a compact msgpack "
            "file with comic_tpu first.")
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    device = next(iter(_leaves(template))).device
    state = bridge.from_jax_tree(tree, device=device)
    _check_like(state, template)
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def save_compact(directory: str, step: int, state: Params) -> str:
    """Write ``model_compact-<step>.msgpack`` (the format comic_tpu reads)
    atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{COMPACT_PREFIX}{int(step)}{_SUFFIX}")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(packb(bridge.to_jax_tree(state)))
    os.replace(tmp, path)
    return path
