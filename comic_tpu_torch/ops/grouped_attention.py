"""K1: beam-grouped add_LN attention decode step.

Counterpart of comic_tpu/ops/grouped_attention.py:grouped_add_ln_attention
(a Pallas kernel). On a CUDA tensor the wrapper launches the hand-written
sm_90a kernel in ``csrc/grouped_add_ln_attention.cu`` (its note gives the
bound and the design); on a CPU tensor it runs ``grouped_add_ln_attention_
plain``, the same math as torch ops. There is no fallback from the card to
the plain version: a CUDA call launches the kernel or raises.

K queries per image share that image's UNtiled keys; the values are the
keys (tied projection). LayerNorm statistics come in closed form from the
precomputed key moments (attention.AttentionMemory). As in comic_tpu's
decode step (comic_tpu/models/attention.py:attend_grouped), the query is
rounded to the keys' dtype before the statistics and the tanh chain, and
the alignments are rounded to it for the context product; the returned
alignments stay float32 and unrounded. (The Pallas kernel keeps the query
and the alignments in float32; in float32 the two agree.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

LN_EPS = 1e-12


def grouped_add_ln_attention_plain(
    query: torch.Tensor, keys: torch.Tensor, key_mean: torch.Tensor,
    key_m2: torch.Tensor, v: torch.Tensor, ln_scale: torch.Tensor,
    ln_bias: torch.Tensor, temperature, *, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch ops of the kernel's math -> (context (B, K, U) f32,
    alignments (B, K, H, L) f32)."""
    b, k, u = query.shape
    l = keys.shape[1]
    d = u // num_heads
    q32 = query.to(keys.dtype).float()
    k32 = keys.float()
    mu_q = q32.mean(dim=-1)  # (B, K)
    m2_q = q32.square().mean(dim=-1)
    cross = torch.matmul(q32, k32.transpose(1, 2))  # (B, K, L)
    mu = key_mean[:, None, :] + mu_q[:, :, None]
    ex2 = key_m2[:, None, :] + 2.0 * cross / u + m2_q[:, :, None]
    inv = torch.rsqrt(torch.clamp(ex2 - mu.square(), min=0.0) + LN_EPS)
    t = (k32[:, None] + q32[:, :, None, :] - mu[..., None]) * inv[..., None]
    s = torch.tanh(t * ln_scale + ln_bias) * v  # (B, K, L, U)
    e = s.reshape(b, k, l, num_heads, d).sum(dim=-1) * (1.0 / temperature)
    align = torch.softmax(e, dim=2).transpose(2, 3).contiguous()
    return grouped_context_plain(align, keys, num_heads=num_heads), align


def grouped_context_plain(align: torch.Tensor, keys: torch.Tensor, *,
                          num_heads: int) -> torch.Tensor:
    """The context over the tied values from alignments (B, K, H, L) f32,
    rounded to the keys' dtype first -> (B, K, U) f32."""
    b, k, _, l = align.shape
    u = keys.shape[-1]
    values = keys.float().reshape(b, l, num_heads, u // num_heads)
    ctx = torch.matmul(align.to(keys.dtype).float().transpose(1, 2),
                       values.permute(0, 2, 1, 3))  # (B, H, K, D)
    return ctx.permute(0, 2, 1, 3).reshape(b, k, u)


_ARGTYPES = [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I,
             _cuda.I, _cuda.I, _cuda.I, _cuda.P]


def grouped_add_ln_attention(
    query: torch.Tensor,  # (B, K, U) f32 projected queries
    keys: torch.Tensor,  # (B, L, U) bf16 or f32, UNtiled (== tied values)
    key_mean: torch.Tensor,  # (B, L) f32 channel mean of the stored keys
    key_m2: torch.Tensor,  # (B, L) f32 channel mean of their squares
    v: torch.Tensor,  # (U,) f32
    ln_scale: torch.Tensor,  # (U,) f32
    ln_bias: torch.Tensor,  # (U,) f32
    temperature: torch.Tensor,  # () f32
    *, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (context (B, K, U) f32, alignments (B, K, H, L) f32)."""
    if keys.device.type == "cpu":
        return grouped_add_ln_attention_plain(
            query, keys, key_mean, key_m2, v, ln_scale, ln_bias, temperature,
            num_heads=num_heads)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"grouped_add_ln_attention: no kernel for {dev}")
    b, l, u = keys.shape
    k = query.shape[1] if query.dim() == 3 else -1
    if u % num_heads:
        raise ValueError(f"units {u} not divisible by heads {num_heads}")
    f32 = (torch.float32,)
    _cuda.check("keys", keys, (b, l, u), (torch.bfloat16, torch.float32),
                dev)
    _cuda.check("query", query, (b, k, u), f32, dev)
    _cuda.check("key_mean", key_mean, (b, l), f32, dev)
    _cuda.check("key_m2", key_m2, (b, l), f32, dev)
    for name, t in (("v", v), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        _cuda.check(name, t, (u,), f32, dev)
    _cuda.check("temperature", temperature.reshape(()), (), f32, dev)
    ctx = torch.empty((b, k, u), dtype=torch.float32, device=dev)
    align = torch.empty((b, k, num_heads, l), dtype=torch.float32,
                        device=dev)
    fn = _cuda.kernel("grouped_add_ln_attention", _ARGTYPES)
    err = fn(query.data_ptr(), keys.data_ptr(),
             int(keys.dtype == torch.bfloat16),
             _cuda.vector_width(keys, u // num_heads), key_mean.data_ptr(),
             key_m2.data_ptr(), v.data_ptr(), ln_scale.data_ptr(),
             ln_bias.data_ptr(), temperature.data_ptr(), ctx.data_ptr(),
             align.data_ptr(), b, k, l, u, num_heads,
             _cuda.stream_handle(dev))
    if err:
        raise RuntimeError(
            f"grouped_add_ln_attention launch failed: CUDA error {err}")
    grouped_add_ln_attention.launches += 1
    return ctx, align


#: kernel launches since the count was last set to 0
grouped_add_ln_attention.launches = 0


def grouped_add_ln_attention_plan(keys: torch.Tensor, beams: int, *,
                                  num_heads: int) -> dict:
    """The kernel's launch plan for these keys (on the card): cluster size,
    grid, shared memory per block, whether the keys are staged."""
    b, l, u = keys.shape
    return _cuda.launch_plan("grouped_add_ln_attention", [
        int(keys.dtype == torch.bfloat16),
        _cuda.vector_width(keys, u // num_heads),
        int(keys.data_ptr() % 16 == 0), b, beams, l, u, num_heads])
