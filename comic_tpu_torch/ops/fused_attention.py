"""K2: flat add_LN attention decode step, one query per row.

Counterpart of comic_tpu/ops/fused_attention.py:fused_add_ln_attention (a
Pallas kernel). On a CUDA tensor the wrapper launches the hand-written
sm_90a kernel in ``csrc/fused_add_ln_attention.cu`` (its note gives the
bound and the design); on a CPU tensor it runs
``fused_add_ln_attention_plain``, the same math as torch ops. A CUDA call
launches the kernel or raises.

Each row has its own keys (tied values). The LayerNorm statistics are taken
in two passes over U, as in the Pallas kernel; the query and the
alignments stay float32 throughout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

LN_EPS = 1e-12


def fused_add_ln_attention_plain(
    query: torch.Tensor, keys: torch.Tensor, v: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor, temperature, *,
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch ops of the kernel's math -> (context (R, U) f32,
    alignments (R, H, L) f32)."""
    r, l, u = keys.shape
    d = u // num_heads
    k32 = keys.float()
    s = k32 + query.float()[:, None, :]
    mean = s.mean(dim=2, keepdim=True)
    var = (s - mean).square().mean(dim=2, keepdim=True)
    s = (s - mean) * torch.rsqrt(var + LN_EPS)
    s = torch.tanh(s * ln_scale + ln_bias) * v  # (R, L, U)
    e = s.reshape(r, l, num_heads, d).sum(dim=-1) * (1.0 / temperature)
    align = torch.softmax(e, dim=1).transpose(1, 2)  # (R, H, L)
    values = k32.reshape(r, l, num_heads, d).permute(0, 2, 1, 3)
    ctx = torch.matmul(align[:, :, None, :], values)  # (R, H, 1, D)
    return ctx.reshape(r, u), align.contiguous()


_ARGTYPES = [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
             _cuda.P]


def fused_add_ln_attention(
    query: torch.Tensor,  # (R, U) f32 projected queries
    keys: torch.Tensor,  # (R, L, U) bf16 or f32 (== tied values)
    v: torch.Tensor,  # (U,) f32
    ln_scale: torch.Tensor,  # (U,) f32
    ln_bias: torch.Tensor,  # (U,) f32
    temperature: torch.Tensor,  # () f32
    *, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (context (R, U) f32, alignments (R, H, L) f32)."""
    if keys.device.type == "cpu":
        return fused_add_ln_attention_plain(
            query, keys, v, ln_scale, ln_bias, temperature,
            num_heads=num_heads)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"fused_add_ln_attention: no kernel for {dev}")
    r, l, u = keys.shape
    if u % num_heads:
        raise ValueError(f"units {u} not divisible by heads {num_heads}")
    f32 = (torch.float32,)
    _cuda.check("keys", keys, (r, l, u), (torch.bfloat16, torch.float32),
                dev)
    _cuda.check("query", query, (r, u), f32, dev)
    for name, t in (("v", v), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        _cuda.check(name, t, (u,), f32, dev)
    _cuda.check("temperature", temperature.reshape(()), (), f32, dev)
    ctx = torch.empty((r, u), dtype=torch.float32, device=dev)
    align = torch.empty((r, num_heads, l), dtype=torch.float32, device=dev)
    fn = _cuda.kernel("fused_add_ln_attention", _ARGTYPES)
    err = fn(query.data_ptr(), keys.data_ptr(),
             int(keys.dtype == torch.bfloat16),
             _cuda.vector_width(keys, u // num_heads), v.data_ptr(),
             ln_scale.data_ptr(), ln_bias.data_ptr(), temperature.data_ptr(),
             ctx.data_ptr(), align.data_ptr(), r, l, u, num_heads,
             _cuda.stream_handle(dev))
    if err:
        raise RuntimeError(
            f"fused_add_ln_attention launch failed: CUDA error {err}")
    fused_add_ln_attention.launches += 1
    return ctx, align


#: kernel launches since the count was last set to 0
fused_add_ln_attention.launches = 0
