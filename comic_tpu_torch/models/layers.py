"""Primitive layers: initializers, dense, layer norm, head reshapes, frozen
BN, TF convolutions (SAME, VALID or explicit pads; depthwise) and pools
(max, and average divided by the in-bounds count).

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


# --- TF convolutions and pools (NCHW) ---------------------------------------

def same_padding(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of TF's SAME rule on one axis: the output
    has ceil(size / stride) positions and the odd pad goes AFTER (the 7x7/2
    stem on 224 pads 2/3, the 3x3/2 pool on 112 pads 0/1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int, padding):
    """((top, bottom), (left, right)) of ``padding``: 'SAME' (TF's rule on
    each axis), 'VALID', or the pairs themselves."""
    if padding == "SAME":
        return (same_padding(x.shape[2], kh, stride),
                same_padding(x.shape[3], kw, stride))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(padding)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding="SAME", groups: int = 1) -> torch.Tensor:
    """TF convolution of NCHW x with an OIHW kernel (any kh x kw).
    Symmetric pads go to the conv itself; asymmetric ones (SAME at stride
    2, slim's fixed pad) are padded first."""
    (pt, pb), (pl, pr) = _pads(x, w.shape[2], w.shape[3], stride, padding)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, stride=stride, padding=(pt, pl), groups=groups)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=stride,
                    groups=groups)


def depthwise_kernel(w: torch.Tensor) -> torch.Tensor:
    """A depthwise kernel as the port stores it, (cin, mult, k, k), as the
    grouped OIHW kernel (cin * mult, 1, k, k) of groups=cin: output
    c * mult + m reads input channel c (a view, no copy)."""
    cin, mult, kh, kw = w.shape
    return w.reshape(cin * mult, 1, kh, kw)


def max_pool(x: torch.Tensor, k: int, stride: int, padding="SAME"
             ) -> torch.Tensor:
    """Max pool; a SAME pad is -inf, so it never wins a window."""
    (pt, pb), (pl, pr) = _pads(x, k, k, stride, padding)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def avg_pool(x: torch.Tensor, k: int, stride: int = 1, padding="SAME"
             ) -> torch.Tensor:
    """tf.nn.avg_pool (comic_tpu's layers.avg_pool_same): a window at the
    edge divides by the number of its IN-BOUNDS elements. torch's
    avg_pool2d pads symmetrically and counts otherwise, so the pad here is
    explicit (asymmetric where TF's is) and the divisor is the window sum
    of a ones image padded the same way."""
    (pt, pb), (pl, pr) = _pads(x, k, k, stride, padding)
    if not (pt or pb or pl or pr):
        return F.avg_pool2d(x, k, stride)
    pad = (pl, pr, pt, pb)
    summed = F.avg_pool2d(F.pad(x, pad), k, stride, divisor_override=1)
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    counts = F.avg_pool2d(F.pad(ones, pad), k, stride, divisor_override=1)
    return summed / counts


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(relu(x), 6), as comic_tpu's mobilenets write it."""
    return torch.clamp(x, 0.0, 6.0)


# --- frozen batch norm --------------------------------------------------------

def frozen_bn(y: torch.Tensor, bn: Params, eps: float) -> torch.Tensor:
    """Inference-mode BN on NCHW float32 ``y``: scale=False (no ``gamma``,
    the inception family) or scale=True (``gamma`` multiplies the inverse
    deviation first, as comic_tpu's resnets and mobilenets do)."""
    inv = torch.rsqrt(bn["moving_variance"] + eps)
    if "gamma" in bn:
        inv = inv * bn["gamma"]
    shape = (1, -1, 1, 1)
    return ((y - bn["moving_mean"].view(shape)) * inv.view(shape)
            + bn["beta"].view(shape))


def conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             padding="SAME", dtype: Optional[torch.dtype] = None,
             groups: int = 1) -> torch.Tensor:
    """The convolution in the compute dtype (input and kernel rounded to
    it, the output in it), then cast to float32 — comic_tpu's
    ``conv(x.astype(dtype), w.astype(dtype)).astype(float32)``."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return conv2d(x, w, stride, padding, groups).float()


def conv_bn(p: Params, x: torch.Tensor, stride: int, eps: float,
            dtype: Optional[torch.dtype] = None, padding="SAME",
            act: Optional[Callable] = torch.relu,
            kernel: Optional[torch.Tensor] = None, groups: int = 1
            ) -> torch.Tensor:
    """conv_f32 of ``p["weights"]`` (or ``kernel``), float32 frozen BN of
    ``p["BatchNorm"]``, then ``act`` (None: linear)."""
    w = p["weights"] if kernel is None else kernel
    y = frozen_bn(conv_f32(x, w, stride, padding, dtype, groups),
                  p["BatchNorm"], eps)
    return y if act is None else act(y)


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


# --- conv parameter initializers (OIHW) --------------------------------------

def conv_kernel(generator: torch.Generator, kh: int, kw: int, cin: int,
                cout: int, fan: Optional[int] = None) -> torch.Tensor:
    """slim's truncated-normal variance scaling over ``fan`` (default
    FAN_IN, kh * kw * cin), drawn in the JAX tree's HWIO shape and stored
    OIHW."""
    fan = kh * kw * cin if fan is None else fan
    hwio = slim_variance_scaling(generator, (kh, kw, cin, cout), fan)
    return hwio.permute(3, 2, 0, 1).contiguous()


def bn_init(c: int, gamma: bool = False) -> Params:
    """Frozen BN statistics at their initial values (``gamma``: scale=True)."""
    bn = {"beta": torch.zeros(c)}
    if gamma:
        bn["gamma"] = torch.ones(c)
    bn["moving_mean"] = torch.zeros(c)
    bn["moving_variance"] = torch.ones(c)
    return bn


def conv_bn_init(generator: torch.Generator, kh: int, kw: int, cin: int,
                 cout: int, gamma: bool = False) -> Params:
    return {"weights": conv_kernel(generator, kh, kw, cin, cout),
            "BatchNorm": bn_init(cout, gamma)}


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
