"""Analytic FLOPs/bytes cost model for roofline and MFU accounting;
counterpart of comic_tpu/utils/roofline.py.

comic_tpu walks a traced jaxpr. The port runs ``fn`` once under a
``TorchDispatchMode`` and counts the aten operations that actually ran:

  - ``matmul_flops`` — 2*M*N*K over every mm / addmm / bmm / baddbmm
                       (einsum, matmul and linear reach these)
  - ``conv_flops``   — 2*out_elems*Cin_per_group*prod(k_spatial) over every
                       convolution, and that again for each gradient a
                       convolution_backward computes
  - ``vpu_elems``    — output-element count of every other arithmetic op
                       (LN, tanh, softmax, masking, sorts). Pure data
                       movement (views, copies, gathers, index, cat, slice,
                       fills) does no arithmetic and is NOT counted here;
                       its traffic shows up in ``bytes_upper``
  - ``bytes_lower``  — the tensors in the arguments plus the outputs (the
                       device-memory traffic of a perfectly fused program)
  - ``bytes_upper``  — per-op operands + results summed (no fusion)

Differences from comic_tpu's walk, by construction:

  - Loops are counted as they ran. comic_tpu's ``while_trip_count`` hint
    has no counterpart: count a fixed-length decode (``infer_early_exit``
    0, or a search with ``early_exit=False``) where comic_tpu passes
    ``while_trip_count=steps``. A loop adds no per-iteration term to
    ``bytes_lower`` either: only the program's own inputs and outputs count.
  - Autograd's backward operations are dispatched too, so a counted train
    step includes its backward and the optimizer's update.
  - ``fn`` really runs, once, with its side effects (a train step updates
    its parameters), and only the calling thread's operations and
    autograd's are seen. A counted call is several times slower than an
    uncounted one: never time it.
  - A copy between the host and the card with no change of dtype is not
    counted (it moves no bytes of device memory in a program that runs on
    the CPU), so a program's count is the same on either device.

The attention kernels K1 and K2 are launched through ctypes, so no
dispatch mode sees their work. Their wrappers report
``add_ln_attention_cost`` (the count comic_tpu's walk gives for the same
part of ``attend_grouped`` / ``attend``) to the active counter through
``ACTIVE.kernel``, which stops counting dispatched operations while the
call runs; the attention step's torch operations on the CPU report the same
cost the same way. A program's count is thus the same whichever route
computes the attention.

MFU here is the standard model-FLOPs utilization: analytic tensor-core
FLOPs / (measured seconds * peak). The peaks are those of one NVIDIA H100
SXM5 (``NVIDIA H100 80GB HBM3``), dense, from NVIDIA's H100 Tensor Core
GPU datasheet, at the full 700 W power limit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM5 peaks (NVIDIA H100 Tensor Core GPU datasheet; dense, no
# sparsity): tensor cores in BF16 and TF32, float32 outside the tensor
# cores, and HBM3 bandwidth
H100_SXM_PEAK_BF16_FLOPS = 989.4e12
H100_SXM_PEAK_TF32_FLOPS = 494.7e12
H100_SXM_PEAK_F32_FLOPS = 67e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12


@dataclass
class Cost:
    matmul_flops: float = 0.0
    conv_flops: float = 0.0
    vpu_elems: float = 0.0
    bytes_lower: float = 0.0  # program I/O (perfect fusion)
    bytes_upper: float = 0.0  # sum of per-op operands+results (no fusion)
    by_primitive: Dict[str, float] = field(default_factory=dict)

    @property
    def mxu_flops(self) -> float:
        return self.matmul_flops + self.conv_flops

    def scaled(self, k: float) -> "Cost":
        return Cost(self.matmul_flops * k, self.conv_flops * k,
                    self.vpu_elems * k, self.bytes_lower * k,
                    self.bytes_upper * k,
                    {p: v * k for p, v in self.by_primitive.items()})

    def __sub__(self, other: "Cost") -> "Cost":
        keys = set(self.by_primitive) | set(other.by_primitive)
        return Cost(
            self.matmul_flops - other.matmul_flops,
            self.conv_flops - other.conv_flops,
            self.vpu_elems - other.vpu_elems,
            self.bytes_lower - other.bytes_lower,
            self.bytes_upper - other.bytes_upper,
            {p: self.by_primitive.get(p, 0.0) - other.by_primitive.get(p, 0.0)
             for p in keys})

    def __iadd__(self, other: "Cost") -> "Cost":
        self.matmul_flops += other.matmul_flops
        self.conv_flops += other.conv_flops
        self.vpu_elems += other.vpu_elems
        self.bytes_lower += other.bytes_lower
        self.bytes_upper += other.bytes_upper
        for p, v in other.by_primitive.items():
            self.by_primitive[p] = self.by_primitive.get(p, 0.0) + v
        return self


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, np.ndarray):
        return float(x.nbytes)
    return 0.0


def _matmul_flops(name: str, args) -> float:
    a, b = args[:2] if name in ("mm", "bmm") else args[1:3]
    # (M, K) @ (K, N) or (B, M, K) @ (B, K, N): 2 * (B) * M * K * N
    return 2.0 * a.numel() * b.shape[-1]


def _conv_flops(x: torch.Tensor, weight: torch.Tensor, out: torch.Tensor,
                transposed: bool) -> float:
    # weight (Cout, Cin/groups, *k): the in-channel extent is already per
    # group; a transposed conv's weight is (Cin, Cout/groups, *k) and its
    # work runs over the input's elements
    k_spatial = math.prod(weight.shape[2:])
    elems = x.numel() if transposed else out.numel()
    return 2.0 * elems * weight.shape[1] * k_spatial


_MATMUL = {"mm", "addmm", "bmm", "baddbmm"}
_COUNTED = _MATMUL | {"convolution", "convolution_backward"}

# aten operations that move, view or create data, or are free at dispatch
# level: no arithmetic (comparisons are NOT here: they count toward
# vpu_elems like any elementwise op)
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "permute", "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
    "as_strided", "alias", "detach", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "diagonal", "unfold", "clone", "contiguous",
    "copy", "copy_", "_to_copy", "lift_fresh", "lift_fresh_copy", "cat",
    "stack", "constant_pad_nd", "flip", "roll", "gather", "scatter",
    "index", "index_select", "index_put", "index_put_", "_index_put_impl_",
    "embedding", "repeat", "repeat_interleave", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_empty", "new_zeros", "new_ones", "new_full",
    "new_empty_strided", "arange", "scalar_tensor", "fill", "fill_",
    "zero_", "_local_scalar_dense", "set_", "resize_", "_pin_memory",
}


class _Counter(TorchDispatchMode):
    """The dispatch mode of one count_costs call."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.paused = 0

    def kernel(self, cost: Cost, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, counted as ``cost`` and none of the
        operations it dispatches: the work of a kernel launched through
        ctypes, or of the torch operations that stand in for it on the
        CPU."""
        self.cost += cost
        self.paused += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self.paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ not in _COUNTED:
            # a composite op (inference mode dispatches conv2d, matmul,
            # linear, ... undecomposed): count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:  # an in-place op that returns nothing (_foreach_*_)
            for a, v in zip(func._schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    outs += [t for t in tree_leaves(v)
                             if isinstance(t, torch.Tensor)]
        if name in ("_to_copy", "copy_"):
            moved = ins + outs
            if (len({t.device for t in moved}) > 1
                    and len({t.dtype for t in moved}) == 1):
                return  # host <-> card, nothing converted
        cost = self.cost
        cost.bytes_upper += sum(_nbytes(t) for t in ins + outs)
        if name in _MATMUL:
            f = _matmul_flops(name, args)
            cost.matmul_flops += f
        elif name == "convolution":
            f = _conv_flops(args[0], args[1], outs[0], bool(args[6]))
            cost.conv_flops += f
        elif name == "convolution_backward":
            grad_out, x, weight = args[:3]
            transposed, mask = bool(args[7]), args[10]
            f = _conv_flops(x, weight, grad_out, transposed) * (
                int(mask[0]) + int(mask[1]))
            cost.conv_flops += f
            if mask[2]:  # the bias gradient: a reduction
                cost.vpu_elems += outs[-1].numel()
        elif name in _FREE:
            return
        else:
            f = float(sum(t.numel() for t in outs))
            cost.vpu_elems += f
        cost.by_primitive[name] = cost.by_primitive.get(name, 0.0) + f


#: the count_costs call in progress: a kernel's wrapper that finds one
#: reports its cost through ``ACTIVE.kernel``; otherwise this one read is
#: all the hook costs
ACTIVE: Optional[_Counter] = None


def add_ln_attention_cost(query: torch.Tensor, keys: torch.Tensor,
                          num_heads: int) -> Cost:
    """One add_LN attention step from projected float32 queries to the
    float32 context and alignments (K1 for (B, K, U) queries over (B, L, U)
    keys, K2 for (R, U) queries over (R, L, U) keys), as comic_tpu's walk
    counts the same part of ``attend_grouped`` / ``attend``: its
    closed-form LN statistics, the tanh chain, the softmax and the
    context, with the casts to and from the keys' dtype where it is not
    float32."""
    grouped = query.dim() == 3
    b, l, u = keys.shape
    w = keys.element_size()
    q = b * (query.shape[1] if grouped else 1)  # queries
    n = q * l  # scores before the head sums
    e = n * u  # elements of the tanh chain
    s = q * num_heads * l  # head scores
    g = q * num_heads  # softmax rows
    kv = b * l * u  # keys (== tied values)
    c = Cost()
    c.matmul_flops = 4.0 * e  # the cross term and the context: 2 * e each
    # the query's mean and mean square 4q + qu; the statistics 10n; the
    # tanh chain 7e; head sums, temperature, softmax 5s + 3g
    c.vpu_elems = 4.0 * q + q * u + 10.0 * n + 7.0 * e + 5.0 * s + 3.0 * g
    c.bytes_upper = (52 * s + 48 * g + 64 * e + 108 * n + 48 * q * u
                     + 48 * q + 4 * kv + 24 * b * l + 36 * u + 32
                     + w * (q * u + 4 * kv + s))
    if w != 4:  # the query, the keys and the alignments cast
        c.bytes_upper += 8 * q * u + 4 * kv + 4 * s + w * (2 * q * u + kv + s)
    if not grouped:  # the (R, 1, U) query and the [:, 0] of its scores
        c.bytes_upper += 16 * s
    name = "grouped_add_ln_attention" if grouped else "fused_add_ln_attention"
    c.by_primitive[name] = c.matmul_flops
    return c


def count_costs(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and return its analytic Cost (see
    the module docstring for what is counted and how it differs from
    comic_tpu's count)."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("count_costs does not nest")
    counter = _Counter()
    ACTIVE = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        ACTIVE = None
    cost = counter.cost
    cost.bytes_lower += sum(_nbytes(x) for x in tree_leaves((args, kwargs)))
    cost.bytes_lower += sum(_nbytes(x) for x in tree_leaves(out))
    return cost


def utilization_fields(cost: Cost, measured_ms: float, *,
                       per_call_items: int = 1,
                       peak_flops: float = H100_SXM_PEAK_BF16_FLOPS,
                       peak_hbm: float = H100_SXM_HBM_BYTES_PER_S,
                       prefix: str = "") -> Dict[str, Any]:
    """Derive the utilization fields from a Cost + measured time.

    mfu               = analytic tensor-core flops / (t * peak flops)
    hbm_util_lower    = compulsory bytes / (t * peak BW)  [>= this is real]
    vpu_gelems_per_s  = achieved elementwise+reduction element rate
    """
    t = measured_ms / 1e3
    if t <= 0:
        return {}
    out = {
        f"{prefix}gflops": round(cost.mxu_flops / 1e9, 3),
        f"{prefix}mfu": round(cost.mxu_flops / (t * peak_flops), 4),
        f"{prefix}vpu_gelems_per_s": round(cost.vpu_elems / t / 1e9, 2),
        f"{prefix}hbm_gb_lower": round(cost.bytes_lower / 1e9, 4),
        f"{prefix}hbm_gb_upper": round(cost.bytes_upper / 1e9, 4),
        f"{prefix}hbm_util_lower": round(
            cost.bytes_lower / (t * peak_hbm), 4),
    }
    if per_call_items > 1:
        out[f"{prefix}gflops_per_item"] = round(
            cost.mxu_flops / per_call_items / 1e9, 3)
    return out
