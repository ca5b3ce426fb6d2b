"""Multi-head visual attention over CNN feature maps, counterpart of
comic_tpu/models/attention.py (reference ops_rnn.py:403-632).

Keys/values are projected once per image (``precompute``); ``attend`` and
``attend_grouped`` are the per-token steps. On CUDA tensors inside the
kernels' domain — add_LN alignment, softmax probability, tied projection,
learned temperature, no alignment dropout, and no input that autograd
must differentiate — the steps run the hand-written kernels
(ops.fused_attention K2 for ``attend``, ops.grouped_attention K1 for
``attend_grouped``). Everywhere else (a training step, and always on the
CPU) they run the torch-ops transcription of comic_tpu's jnp code below.

Both routes round the projected query to the keys' dtype before scoring
and the alignments to the values' dtype before the context product, as
comic_tpu's decode steps do; the kernels do it inside.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.fused_attention import fused_add_ln_attention
from ..ops.grouped_attention import grouped_add_ln_attention
from ..utils import roofline
from .layers import (
    dense_apply,
    dense_init,
    layer_norm_apply,
    layer_norm_init,
    matmul_f32,
    split_heads,
    xavier_uniform,
)

Params = Dict[str, Any]


class AttentionConfig(NamedTuple):
    num_units: int  # attention depth (== rnn_size in the reference)
    num_heads: int
    memory_channels: int  # CNN feature-map channel count
    alignment: str = "add_LN"  # add_LN | add | dot
    probability: str = "softmax"  # softmax | sigmoid
    fm_projection: Optional[str] = "tied"  # None | 'tied' | 'independent'
    context_layer: bool = False  # extra linear on the context vector
    scale: bool = True  # learned softmax temperature (add_LN)

    @property
    def context_size(self) -> int:
        """Raw feature-map channels when no projection and no context
        layer, else num_units (model_base.py:610-613)."""
        if self.fm_projection is None and not self.context_layer:
            return self.memory_channels
        return self.num_units


class AttentionMemory(NamedTuple):
    """Per-image precomputed tensors, loop-invariant during decode.

    For add_LN, ``key_mean``/``key_m2`` are the per-position channel
    moments of the STORED keys (float32), from which a step takes the
    LayerNorm statistics of (keys + q) in closed form:
      mean(k+q) = mean(k) + mean(q)
      E[(k+q)^2] = E[k^2] + 2 E[k q] + E[q^2],  E[k q] = one matmul.
    """

    keys: torch.Tensor  # (B, L, U)
    values: torch.Tensor  # (B, H, L, D) split into heads
    key_mean: Optional[torch.Tensor] = None  # (B, L) f32
    key_m2: Optional[torch.Tensor] = None  # (B, L) f32


def attention_init(generator: torch.Generator, cfg: AttentionConfig,
                   init=xavier_uniform) -> Params:
    p: Params = {
        "query_layer": dense_init(generator, cfg.num_units, cfg.num_units,
                                  use_bias=False, init=init),
        "memory_layer": dense_init(generator, cfg.memory_channels,
                                   cfg.num_units, use_bias=False, init=init),
    }
    if cfg.alignment in ("add_LN", "add"):
        p["v"] = init(generator, (cfg.num_units,))
        if cfg.alignment == "add_LN":
            p["ln"] = layer_norm_init(cfg.num_units)
            # the learned temperature belongs to MultiHeadAddLN only
            # (ops_rnn.py:554-563)
            if cfg.scale:
                p["softmax_temperature"] = torch.tensor(5.0)
    if cfg.fm_projection == "independent":
        p["value_layer"] = dense_init(generator, cfg.memory_channels,
                                      cfg.num_units, use_bias=False,
                                      init=init)
    if cfg.context_layer:
        context_in = (cfg.memory_channels if cfg.fm_projection is None
                      else cfg.num_units)
        p["a_layer"] = dense_init(generator, context_in, cfg.num_units,
                                  use_bias=False, init=init)
    return p


def precompute(p: Params, cfg: AttentionConfig, feature_map: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> AttentionMemory:
    """Project the (B, L, C) feature map into keys and per-head values,
    STORED in the compute dtype when one is set (the decode loop re-reads
    them every step). add_LN key moments come from the stored keys."""
    def store(x):
        return x if dtype is None else x.to(dtype)

    keys = store(dense_apply(p["memory_layer"], feature_map, dtype=dtype))
    key_mean = key_m2 = None
    if cfg.alignment == "add_LN":
        k32 = keys.float()
        key_mean = k32.mean(dim=-1)
        key_m2 = k32.square().mean(dim=-1)
    if cfg.fm_projection == "tied":
        values = split_heads(keys, cfg.num_heads)
    elif cfg.fm_projection == "independent":
        values = split_heads(
            store(dense_apply(p["value_layer"], feature_map, dtype=dtype)),
            cfg.num_heads)
    elif cfg.fm_projection is None:
        if cfg.memory_channels % cfg.num_heads != 0:
            raise ValueError(
                "For `none` projection the channel dim must divide num_heads")
        values = split_heads(store(feature_map), cfg.num_heads)
    else:
        raise ValueError(f"Invalid fm_projection: {cfg.fm_projection}")
    return AttentionMemory(keys=keys, values=values,
                           key_mean=key_mean, key_m2=key_m2)


LN_EPS = 1e-12  # contrib layer_norm default


def _add_ln_scores_fast(p: Params, cfg: AttentionConfig,
                        memory: AttentionMemory,
                        proj_q: torch.Tensor) -> torch.Tensor:
    """add_LN head scores (B, K, H, L) with closed-form LayerNorm
    statistics (see AttentionMemory). proj_q: (B, K, U)."""
    keys = memory.keys  # (B, L, U)
    u = keys.shape[-1]
    q32 = proj_q.float()
    mu_q = q32.mean(dim=-1)  # (B, K)
    m2_q = q32.square().mean(dim=-1)
    cross = torch.matmul(proj_q.to(keys.dtype).float(),
                         keys.float().transpose(1, 2))  # (B, K, L)
    mu = memory.key_mean[:, None, :] + mu_q[:, :, None]
    ex2 = memory.key_m2[:, None, :] + 2.0 * cross / u + m2_q[:, :, None]
    var = torch.clamp(ex2 - mu.square(), min=0.0)
    inv = torch.rsqrt(var + LN_EPS)  # (B, K, L)
    x = keys[:, None].float() + q32[:, :, None, :]  # (B, K, L, U)
    y = torch.tanh((x - mu[..., None]) * inv[..., None] * p["ln"]["scale"]
                   + p["ln"]["bias"])
    y = y * p["v"]
    b, k, l, _ = y.shape
    score = y.reshape(b, k, l, cfg.num_heads, u // cfg.num_heads).sum(dim=4)
    score = score.permute(0, 1, 3, 2)  # (B, K, H, L)
    if cfg.scale:
        score = score / p["softmax_temperature"]
    return score


def _probability(cfg: AttentionConfig, score: torch.Tensor) -> torch.Tensor:
    if cfg.probability == "softmax":
        return torch.softmax(score, dim=-1)
    if cfg.probability == "sigmoid":
        s = torch.sigmoid(score)
        return s / s.sum(dim=-1, keepdim=True)
    raise ValueError(f"Invalid probability fn: {cfg.probability}")


def _kernel_domain(p: Params, cfg: AttentionConfig, memory: AttentionMemory,
                   proj_q: torch.Tensor) -> bool:
    """True where the step is a kernel's work: the kernels' configuration,
    and no input that autograd must differentiate (on the card the kernel
    then takes it). The kernels are forward-only (their outputs carry no
    grad_fn), as the Pallas kernels are; a training step takes the torch
    ops below."""
    if not (cfg.alignment == "add_LN" and cfg.probability == "softmax"
            and cfg.fm_projection == "tied" and cfg.scale
            and memory.key_mean is not None):
        return False
    inputs = (proj_q, memory.keys, memory.key_mean, memory.key_m2, p["v"],
              p["ln"]["scale"], p["ln"]["bias"], p["softmax_temperature"])
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in inputs))


def _as_kernel(ops, p: Params, cfg: AttentionConfig,
               memory: AttentionMemory, proj_q: torch.Tensor):
    """``ops(p, cfg, memory, proj_q)``: the torch operations that stand in
    for a kernel off the card. Under roofline.count_costs they count as the
    kernel's work (roofline.add_ln_attention_cost), as the kernel's wrapper
    reports it on the card, so that a count does not depend on the route."""
    if roofline.ACTIVE is None:
        return ops(p, cfg, memory, proj_q)
    return roofline.ACTIVE.kernel(
        roofline.add_ln_attention_cost(proj_q, memory.keys, cfg.num_heads),
        ops, p, cfg, memory, proj_q)


def _head_sums(score: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., L, U) -> (..., H, L) float32 per-head channel sums."""
    *lead, l, u = score.shape
    s = score.float().reshape(*lead, l, num_heads, u // num_heads).sum(-1)
    return s.transpose(-1, -2)


def attend(p: Params, cfg: AttentionConfig, query: torch.Tensor,
           memory: AttentionMemory, dtype: Optional[torch.dtype] = None,
           alignments_keep_mask: Optional[torch.Tensor] = None,
           alignments_keep_prob: float = 1.0,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention step.

    Args:
      query: (B, U) decoder hidden state.
      memory: precomputed keys/values.
      alignments_keep_mask: optional (B, H, L) bool attention-map dropout
        mask (train time; the kernel never takes it).
    Returns:
      (context (B, context_size) f32, alignments (B, H, L)).
    """
    dropout = alignments_keep_mask is not None and alignments_keep_prob < 1.0
    proj_q = dense_apply(p["query_layer"], query, dtype=dtype)
    if dropout or not _kernel_domain(p, cfg, memory, proj_q):
        context, alignments = _attend_ops(p, cfg, memory, proj_q,
                                          alignments_keep_mask,
                                          alignments_keep_prob)
    elif memory.keys.is_cuda:
        context, alignments = fused_add_ln_attention(
            proj_q, memory.keys, p["v"], p["ln"]["scale"], p["ln"]["bias"],
            p["softmax_temperature"], num_heads=cfg.num_heads)
    else:
        context, alignments = _as_kernel(_attend_ops, p, cfg, memory, proj_q)
    if cfg.context_layer:
        context = dense_apply(p["a_layer"], context, dtype=dtype)
    return context, alignments


def _attend_ops(p: Params, cfg: AttentionConfig, memory: AttentionMemory,
                proj_q: torch.Tensor,
                alignments_keep_mask: Optional[torch.Tensor] = None,
                alignments_keep_prob: float = 1.0,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """attend's torch ops from the projected query -> (context (B, U) f32
    before the context layer, alignments (B, H, L))."""
    proj_q = proj_q[:, None, :].to(memory.keys.dtype)
    if cfg.alignment == "add_LN" and memory.key_mean is not None:
        score = _add_ln_scores_fast(p, cfg, memory, proj_q)[:, 0]  # (B,H,L)
    elif cfg.alignment in ("add_LN", "add"):
        score = memory.keys + proj_q  # (B, L, U)
        if cfg.alignment == "add_LN":
            score = layer_norm_apply(p["ln"], score, activation=torch.tanh)
        else:
            score = torch.tanh(score)
        score = _head_sums(score * p["v"].to(score.dtype), cfg.num_heads)
        if cfg.scale and cfg.alignment == "add_LN":
            score = score / p["softmax_temperature"]
    elif cfg.alignment == "dot":
        score = _head_sums(memory.keys * proj_q, cfg.num_heads)
        score = score / torch.sqrt(
            torch.tensor(cfg.num_units / cfg.num_heads, dtype=torch.float32))
    else:
        raise ValueError(f"Invalid alignment method: {cfg.alignment}")

    alignments = _probability(cfg, score)  # (B, H, L)
    attn_for_context = alignments
    if alignments_keep_mask is not None and alignments_keep_prob < 1.0:
        attn_for_context = torch.where(
            alignments_keep_mask, alignments / alignments_keep_prob,
            torch.zeros((), dtype=alignments.dtype))
    # context_h = alignments_h @ values_h -> (B, H, D) -> (B, H*D)
    context = matmul_f32(
        attn_for_context.to(memory.values.dtype)[:, :, None, :],
        memory.values)
    context = context.reshape(context.shape[0], -1)
    # the DROPPED maps are returned, as the reference records them
    return context.float(), attn_for_context


def attend_grouped(p: Params, cfg: AttentionConfig, query: torch.Tensor,
                   memory: AttentionMemory,
                   dtype: Optional[torch.dtype] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-grouped attention step: K queries per image share one memory.

    Args:
      query: (B, K, U) — K beam hypotheses per image.
      memory: UNtiled per-image keys/values ((B, L, U) / (B, H, L, D)).
    Returns:
      (context (B, K, context_size) f32, alignments (B, K, H, L)).
    """
    proj_q = dense_apply(p["query_layer"], query, dtype=dtype)
    if not _kernel_domain(p, cfg, memory, proj_q):
        context, alignments = _attend_grouped_ops(p, cfg, memory, proj_q)
    elif memory.keys.is_cuda:
        context, alignments = grouped_add_ln_attention(
            proj_q, memory.keys, memory.key_mean, memory.key_m2, p["v"],
            p["ln"]["scale"], p["ln"]["bias"], p["softmax_temperature"],
            num_heads=cfg.num_heads)
    else:
        context, alignments = _as_kernel(_attend_grouped_ops, p, cfg, memory,
                                         proj_q)
    if cfg.context_layer:
        context = dense_apply(p["a_layer"], context, dtype=dtype)
    return context, alignments


def _attend_grouped_ops(p: Params, cfg: AttentionConfig,
                        memory: AttentionMemory, proj_q: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """attend_grouped's torch ops from the projected queries -> (context
    (B, K, U) f32 before the context layer, alignments (B, K, H, L))."""
    b, k, _ = proj_q.shape
    proj_q = proj_q.to(memory.keys.dtype)
    keys = memory.keys[:, None]  # (B, 1, L, U)
    if cfg.alignment == "add_LN" and memory.key_mean is not None:
        score = _add_ln_scores_fast(p, cfg, memory, proj_q)  # (B, K, H, L)
    elif cfg.alignment in ("add_LN", "add"):
        score = keys + proj_q[:, :, None, :]  # (B, K, L, U)
        if cfg.alignment == "add_LN":
            score = layer_norm_apply(p["ln"], score, activation=torch.tanh)
        else:
            score = torch.tanh(score)
        score = _head_sums(score * p["v"].to(score.dtype), cfg.num_heads)
        if cfg.scale and cfg.alignment == "add_LN":
            score = score / p["softmax_temperature"]
    elif cfg.alignment == "dot":
        score = _head_sums(keys * proj_q[:, :, None, :], cfg.num_heads)
        score = score / torch.sqrt(
            torch.tensor(cfg.num_units / cfg.num_heads, dtype=torch.float32))
    else:
        raise ValueError(f"Invalid alignment method: {cfg.alignment}")

    alignments = _probability(cfg, score)  # (B, K, H, L)
    # (B, H, K, L) @ (B, H, L, D) -> (B, H, K, D) -> (B, K, H*D)
    context = matmul_f32(alignments.to(memory.values.dtype).transpose(1, 2),
                         memory.values)
    context = context.transpose(1, 2).reshape(b, k, -1)
    return context.float(), alignments
