"""The weight bridge between comic_tpu's parameter tree and the port's.

Both packages use the same nested dict with the same keys (TF-slim names,
e.g. ``encoder/cnn/Mixed_4f/Branch_1/Conv2d_0b_3x3/weights``; the nasnet
family keeps compound leaf keys such as ``separable_5x5_1/depthwise_weights``
and ``conv0/weights``). The only layout change is at this boundary, for
convolution kernels, keyed by the last name of the leaf:

  ``weights``, ``pointwise_weights``: HWIO in the JAX tree, OIHW here;
  ``depthwise_weights``: slim's (k, k, cin, mult) there, (cin, mult, k, k)
      here. The grouped OIHW kernel the convolution takes, (cin * mult, 1,
      k, k), is a view of it (layers.depthwise_kernel); keeping cin and mult
      apart is what lets the round trip restore slim's shape.

Dense kernels stay (in, out). The round trip is exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import DeviceLike, resolve_device

Params = Dict[str, Any]

# leaf name -> (JAX -> port, port -> JAX) axis orders of 4-D kernels
_KERNEL_PERMS = {
    "weights": ((3, 2, 0, 1), (2, 3, 1, 0)),
    "pointwise_weights": ((3, 2, 0, 1), (2, 3, 1, 0)),
    "depthwise_weights": ((2, 3, 0, 1), (2, 3, 0, 1)),
}


def _perm(key: str, ndim: int, direction: int):
    """The axis order for a leaf named ``key`` (its last '/' part), or
    None where the layout stays."""
    perms = _KERNEL_PERMS.get(key.rsplit("/", 1)[-1])
    return perms[direction] if perms is not None and ndim == 4 else None


def jax_shape(key: str, shape) -> list:
    """The shape in comic_tpu's layout of a port leaf named ``key``."""
    perm = _perm(key, len(shape), 1)
    return [shape[i] for i in perm] if perm is not None else list(shape)


def port_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf named ``key`` in comic_tpu's layout -> the port's."""
    perm = _perm(key, t.dim(), 0)
    return t if perm is None else t.permute(*perm).contiguous()


def from_jax_tree(tree: Params, device: DeviceLike = None) -> Params:
    """Nested dict of numpy arrays (comic_tpu layout) -> nested dict of
    tensors on ``device`` (None: the card)."""
    device = resolve_device(device)

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        return port_layout(key, torch.from_numpy(np.array(x, copy=True))
                           ).to(device)

    return {k: conv(k, v) for k, v in tree.items()}


def to_jax_tree(state: Params) -> Params:
    """Nested dict of tensors (port layout) -> nested dict of numpy arrays
    in comic_tpu's layout."""

    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        t = x.detach().cpu()
        perm = _perm(key, t.dim(), 1)
        if perm is not None:
            t = t.permute(*perm).contiguous()
        return t.numpy()

    return {k: conv(k, v) for k, v in state.items()}
