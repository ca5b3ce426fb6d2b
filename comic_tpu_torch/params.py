"""The weight bridge between comic_tpu's parameter tree and the port's.

Both packages use the same nested dict with the same keys (TF-slim names,
e.g. ``encoder/cnn/Mixed_4f/Branch_1/Conv2d_0b_3x3/weights``). The only
layout change is at this boundary: conv kernels are HWIO in the JAX tree
and OIHW in the port. Dense kernels stay (in, out). The round trip is
exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import DeviceLike, resolve_device

Params = Dict[str, Any]


def _is_conv_kernel(key: str, ndim: int) -> bool:
    return key == "weights" and ndim == 4


def from_jax_tree(tree: Params, device: DeviceLike = None) -> Params:
    """Nested dict of numpy arrays (comic_tpu layout) -> nested dict of
    tensors on ``device`` (None: the card)."""
    device = resolve_device(device)

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True))
        if _is_conv_kernel(key, t.dim()):
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    return {k: conv(k, v) for k, v in tree.items()}


def to_jax_tree(state: Params) -> Params:
    """Nested dict of tensors (port layout) -> nested dict of numpy arrays
    in comic_tpu's layout."""

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        t = x.detach().cpu()
        if _is_conv_kernel(key, t.dim()):
            t = t.permute(2, 3, 1, 0).contiguous()
        return t.numpy()

    return {k: conv(k, v) for k, v in state.items()}
