"""Primitive layers: initializers, dense, layer norm, head reshapes, frozen
BN, TF-"SAME" convolutions and pools.

Counterpart of comic_tpu/models/layers.py. Parameters are the JAX tree's
nested dicts with torch tensors as leaves; conv kernels are OIHW (the only
layout change at the boundary, see params.py), dense kernels stay (in, out)
and are applied as ``x @ W``. Feature maps are NCHW inside the port.

Mixed precision: with a compute ``dtype`` (bfloat16) the reference rounds
the matmul operands to that dtype and takes the product in float32
(``preferred_element_type=float32``). ``torch.matmul`` on bfloat16 operands
would round the RESULT to bfloat16 as well, so the port rounds the
operands and multiplies them in float32 instead (``matmul_f32``): the
products of bfloat16 values are exact in float32, which is what the
reference computes. Convolutions run fully in the compute dtype, as the
reference's do (its conv output is bfloat16 before the float32 cast).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --- initializers (same distributions as comic_tpu, not the same bits) ----

def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape
    # conv kernels are HWIO in the JAX tree, the shape these follow
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """slim.xavier_initializer (uniform Glorot)."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def he_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, _ = _fans(shape)
    limit = math.sqrt(6.0 / fan_in)
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


# stddev correction of a normal truncated at +/-2 sigma (tf's
# variance_scaling_initializer divides by it)
_TRUNC_CORRECTION = 0.87962566103423978


def slim_variance_scaling(generator: torch.Generator, shape,
                          fan: int) -> torch.Tensor:
    """slim.variance_scaling_initializer(factor=2.0, truncated normal):
    stddev = sqrt(2/fan) / 0.8796..."""
    std = math.sqrt(2.0 / max(fan, 1)) / _TRUNC_CORRECTION
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def get_initializer(name: Optional[str]) -> Callable:
    """'xavier' | 'he' | None."""
    if name in (None, "none", "xavier"):
        return xavier_uniform
    if name == "he":
        return he_uniform
    raise ValueError(f"Unknown initialiser: {name}")


# --- dense ----------------------------------------------------------------

def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w with a float32 result; with ``dtype`` set both operands are
    first rounded to it (see the module docstring)."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return torch.matmul(x.float(), w.float())


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True, init: Callable = xavier_uniform
               ) -> Params:
    p = {"kernel": init(generator, (in_dim, out_dim))}
    if use_bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def dense_apply(p: Params, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W (+ b), float32 result."""
    y = matmul_f32(x, p["kernel"], dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


# --- layer norm -----------------------------------------------------------

def layer_norm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-12,
                     activation: Optional[Callable] = None) -> torch.Tensor:
    """LayerNorm over the last axis (f32 statistics, contrib eps 1e-12),
    then an optional activation; the result keeps x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"] + p["bias"]
    if activation is not None:
        y = activation(y)
    return y.to(x.dtype)


# --- multi-head reshapes ----------------------------------------------------

def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, C // H)."""
    b, l, c = x.shape
    if c % num_heads != 0:
        raise ValueError(f"Channels {c} not divisible by heads {num_heads}")
    return x.reshape(b, l, num_heads, c // num_heads).permute(0, 2, 1, 3)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) -> (B, L, H * D)."""
    b, h, l, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * d)


# --- TF "SAME" convolutions and pools (NCHW) ---------------------------------

def same_padding(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of TF's SAME rule on one axis: the output
    has ceil(size / stride) positions and the odd pad goes AFTER (the 7x7/2
    stem on 224 pads 2/3, the 3x3/2 pool on 112 pads 0/1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int):
    ph = same_padding(x.shape[2], k, stride)
    pw = same_padding(x.shape[3], k, stride)
    return ph, pw


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int
                ) -> torch.Tensor:
    """SAME conv of NCHW x with an OIHW kernel (square). Symmetric pads go
    to the conv itself; asymmetric ones (stride 2) are padded first, since
    ``padding='same'`` refuses a stride above 1."""
    ph, pw = _pads(x, w.shape[2], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """SAME max pool: the pad is -inf, so it never wins a window."""
    ph, pw = _pads(x, k, stride)
    if any(ph) or any(pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


# --- frozen batch norm --------------------------------------------------------

def frozen_bn(y: torch.Tensor, bn: Params, eps: float) -> torch.Tensor:
    """Inference-mode BN with scale=False on NCHW float32 ``y``."""
    inv = torch.rsqrt(bn["moving_variance"] + eps)
    shape = (1, -1, 1, 1)
    return ((y - bn["moving_mean"].view(shape)) * inv.view(shape)
            + bn["beta"].view(shape))


def conv_bn_relu(p: Params, x: torch.Tensor, stride: int, eps: float,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME conv in the compute dtype, float32 frozen BN, relu."""
    w = p["weights"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = conv2d_same(x, w, stride).float()
    return torch.relu(frozen_bn(y, p["BatchNorm"], eps))


def merged_1x1_bn_relu(parts: Sequence[Params], x: torch.Tensor, eps: float,
                       dtype: Optional[torch.dtype] = None
                       ) -> List[torch.Tensor]:
    """N independent 1x1/stride-1 conv + frozen-BN + relu branches over the
    same input, run as ONE conv with concatenated output channels.

    Each output channel of a 1x1 conv is an independent dot over the same
    input pixel, so the merged conv is exact per branch (comic_tpu's
    layers.merged_1x1_bn_relu). Only 1x1 kernels may be merged; the kernel
    shape is checked with a real raise.
    """
    for q in parts:
        if tuple(q["weights"].shape[2:]) != (1, 1):
            raise ValueError(
                f"merged_1x1_bn_relu got a {tuple(q['weights'].shape[2:])} "
                "kernel — only 1x1/stride-1/SAME first convs are mergeable.")
    w = torch.cat([q["weights"] for q in parts], dim=0)
    xin = x if dtype is None else x.to(dtype)
    y = F.conv2d(xin, w.to(xin.dtype)).float()
    bn = {key: torch.cat([q["BatchNorm"][key] for q in parts])
          for key in ("moving_mean", "moving_variance", "beta")}
    y = torch.relu(frozen_bn(y, bn, eps))
    return list(torch.split(y, [q["weights"].shape[0] for q in parts], dim=1))


# --- misc -----------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def l2_loss(params, decay: float) -> torch.Tensor:
    """decay * sum_v ||v||^2 / 2 over every leaf (reference ops.py:184-190)."""
    leaves = tree_leaves(params)
    if not leaves or decay <= 0:
        return torch.zeros(())
    return decay * sum(0.5 * v.float().square().sum() for v in leaves)


def count_params(params) -> int:
    """Parameter count (reference ops.get_model_size, common/ops.py:62-91)."""
    return sum(math.prod(v.shape) for v in tree_leaves(params))
