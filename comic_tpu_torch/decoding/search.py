"""Caption decoding on the device: greedy (or sampled) and beam search.
Counterpart of comic_tpu/decoding/search.py (reference ops_rnn.py:49-243
and contrib's BeamSearchDecoder).

The loops are eager Python over fixed-shape hypothesis state; batch x beam
is folded into one leading axis, the attention memory stays per image
(beam-grouped steps), and beam hypotheses are rebuilt after the loop by one
parent-pointer backtrack.

Semantics kept from contrib (and comic_tpu):
  - finished beams are locked to emit EOS with zero added log-prob;
  - the selection-time length leaves the EOS-emitting step uncounted while
    the carried length counts it;
  - Google-NMT length penalty ((5 + len) / 6) ** alpha;
  - the final beam order is the last step's top-k order;
  - on an early exit the frozen beams are re-scored as the full-length
    loop would have;
  - greedy writes PAD (-1) after a row has finished.
``jax.lax.top_k`` breaks ties to the lowest flat index; ``torch.topk``
promises no order, so selection is a stable descending sort.

Early exit: the all-finished test is a host sync in eager PyTorch, so it
runs every ``EXIT_CHECK_EVERY`` steps. Steps after every beam has finished
only re-sort the frozen beams by their final scores (which the final order
does anyway) and write EOS/PAD, so the outputs equal a test at every step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.attention import AttentionMemory, precompute
from ..models.captioner import ModelSpec, Params
from ..models.decoder import (
    embed_ids,
    initial_state,
    step as decoder_step,
    step_grouped,
)
from ..models.encoders import encode_images

NEG_INF = -1e9
EXIT_CHECK_EVERY = 4


class DecodeOutput(NamedTuple):
    ids: torch.Tensor  # (B, T) generated token ids (PAD/EOS after finish)
    scores: torch.Tensor  # (B,) sum log prob (greedy) or beam score
    alignments: torch.Tensor  # (B, H, T, L) attention maps
    lengths: torch.Tensor  # (B,) decode steps INCLUDING the EOS one


def _prepare_memory(params: Params, spec: ModelSpec, images: torch.Tensor
                    ) -> Tuple[torch.Tensor, AttentionMemory]:
    im_embed, fmaps = encode_images(
        params["encoder"], images, spec.cnn_name, spec.fm_endpoint,
        legacy=spec.legacy, dtype=spec.compute_dtype)
    memory = precompute(params["decoder"]["attention"],
                        spec.decoder.attention, fmaps,
                        dtype=spec.compute_dtype)
    return im_embed, memory


def _exit_now(t: int, finished: torch.Tensor) -> bool:
    return t > 0 and t % EXIT_CHECK_EVERY == 0 and bool(finished.all())


# --------------------------------------------------------------------------
# Greedy search (ops_rnn.py:115-180 semantics)
# --------------------------------------------------------------------------

def greedy_or_sample(
    params: Params, spec: ModelSpec, images: torch.Tensor, *,
    max_steps: int, sample: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None, collect_alignments: bool = True,
    early_exit: bool = False,
) -> DecodeOutput:
    """Greedy argmax decode, or multinomial sampling when ``sample``."""
    im_embed, memory = _prepare_memory(params, spec, images)
    return greedy_or_sample_from_memory(
        params["decoder"], spec, im_embed, memory, max_steps=max_steps,
        sample=sample, generator=generator, noise=noise,
        collect_alignments=collect_alignments, early_exit=early_exit)


def _gumbel(shape, generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    jax.random.gumbel draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def greedy_or_sample_from_memory(
    dec_params: Params, spec: ModelSpec, im_embed: torch.Tensor,
    memory: AttentionMemory, *, max_steps: int, sample: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None, collect_alignments: bool = True,
    early_exit: bool = False,
) -> DecodeOutput:
    """Greedy search over precomputed encoder outputs, or with ``sample``
    a draw from the softmax at every step: argmax(logp + Gumbel noise),
    the draw jax.random.categorical makes. The noise of step t is
    ``noise[t]`` ((max_steps, B, V), e.g. comic_tpu's own draws in a
    test), else drawn from ``generator`` on the decode's device."""
    dcfg = spec.decoder
    dtype = spec.compute_dtype
    device = im_embed.device
    batch = im_embed.shape[0]
    heads = dcfg.attention.num_heads
    mem_len = memory.keys.shape[1]

    dec_state = initial_state(dec_params, dcfg, im_embed, dtype=dtype)
    prev = torch.full((batch,), dcfg.start_id, dtype=torch.long,
                      device=device)
    finished = torch.zeros((batch,), dtype=torch.bool, device=device)
    log_prob = torch.zeros((batch,), device=device)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    ids = torch.full((max_steps, batch), -1, dtype=torch.long, device=device)
    aligns = []
    stop_early = early_exit and not collect_alignments
    for t in range(max_steps):
        if stop_early and _exit_now(t, finished):
            break
        wv = embed_ids(dec_params, dcfg, prev, dtype=dtype)
        logits, align, dec_state = decoder_step(
            dec_params, dcfg, wv, dec_state, memory, dtype=dtype)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if not sample:
            nxt = torch.argmax(logp, dim=-1)
        elif noise is not None:
            nxt = torch.argmax(logp + noise[t].to(device), dim=-1)
        else:
            nxt = torch.argmax(logp + _gumbel(logp.shape, generator, device),
                               dim=-1)
        tok_logp = logp.gather(1, nxt[:, None])[:, 0]
        ids[t] = torch.where(finished, -1, nxt)  # finished rows emit PAD
        log_prob = log_prob + torch.where(finished, 0.0, tok_logp)
        lengths = lengths + (~finished).to(torch.int32)
        if collect_alignments:
            aligns.append(align.float() * (~finished)[:, None, None])
        finished = finished | (nxt == dcfg.end_id)
        prev = nxt

    if collect_alignments:
        alignments = torch.stack(aligns, dim=2)  # (B, H, T, L)
    else:
        alignments = torch.zeros((batch, heads, max_steps, mem_len),
                                 device=device)
    return DecodeOutput(ids=ids.transpose(0, 1).to(torch.int32),
                        scores=log_prob, alignments=alignments,
                        lengths=lengths)


# --------------------------------------------------------------------------
# Beam search
# --------------------------------------------------------------------------

def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """Google-NMT penalty ((5 + len) / 6) ** alpha, the contrib formula."""
    if alpha == 0.0:
        return torch.ones(lengths.shape, device=lengths.device)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def _map_state(fn, state):
    """fn applied to every tensor of a (nested NamedTuple) decoder state."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    return type(state)(*(_map_state(fn, s) for s in state))


def _gather_beams(state, parent: torch.Tensor, batch: int, k: int):
    """Reorder the (B*K, ...) tensors of a state by per-image parent beam
    indices (B, K)."""
    rows = (parent + torch.arange(batch, device=parent.device)[:, None] * k
            ).reshape(-1)
    return _map_state(lambda x: x[rows], state)


def beam_search(
    params: Params, spec: ModelSpec, images: torch.Tensor, *,
    beam_size: int, max_steps: int, length_penalty: float = 0.0,
    collect_alignments: bool = True, early_exit: bool = False,
) -> Tuple[DecodeOutput, Dict[str, torch.Tensor]]:
    """Batched beam search -> (top-beam DecodeOutput, all-beam ids/scores
    in the reference's (beam, batch, time) layout)."""
    im_embed, memory = _prepare_memory(params, spec, images)
    return beam_search_from_memory(
        params["decoder"], spec, im_embed, memory, beam_size=beam_size,
        max_steps=max_steps, length_penalty=length_penalty,
        collect_alignments=collect_alignments, early_exit=early_exit)


def beam_search_from_memory(
    dec_params: Params, spec: ModelSpec, im_embed: torch.Tensor,
    memory: AttentionMemory, *, beam_size: int, max_steps: int,
    length_penalty: float = 0.0, collect_alignments: bool = True,
    early_exit: bool = False,
) -> Tuple[DecodeOutput, Dict[str, torch.Tensor]]:
    """Beam search over precomputed encoder outputs. ``early_exit`` stops
    once every beam has emitted EOS (contrib dynamic_decode); it applies
    only without alignment collection, and its outputs equal the
    full-length loop's."""
    dcfg = spec.decoder
    dtype = spec.compute_dtype
    device = im_embed.device
    k = beam_size
    batch = im_embed.shape[0]
    heads = dcfg.attention.num_heads
    mem_len = memory.keys.shape[1]
    vocab = dcfg.softmax_size

    # beams share their image's memory (untiled); only the small decoder
    # state is replicated: row b*K + j is image b
    dec_state = _map_state(lambda x: x.repeat_interleave(k, dim=0),
                           initial_state(dec_params, dcfg, im_embed,
                                         dtype=dtype))

    # beam 0 starts live, the others at -inf so step 1 picks distinct
    # continuations of the start token
    log_probs = torch.full((batch, k), NEG_INF, device=device)
    log_probs[:, 0] = 0.0
    prev = torch.full((batch, k), dcfg.start_id, dtype=torch.long,
                      device=device)
    finished = torch.zeros((batch, k), dtype=torch.bool, device=device)
    lengths = torch.zeros((batch, k), dtype=torch.int32, device=device)

    eos_col = torch.arange(vocab, device=device) == dcfg.end_id
    locked = torch.where(eos_col, 0.0, NEG_INF)  # (V,)
    not_eos = (~eos_col).to(torch.int32)  # 0 at end_id

    tokens, parents, aligns = [], [], []
    sel_scores = None
    stop_early = early_exit and not collect_alignments
    stopped_at = max_steps
    for t in range(max_steps):
        if stop_early and _exit_now(t, finished):
            stopped_at = t
            break
        wv = embed_ids(dec_params, dcfg, prev.reshape(-1), dtype=dtype)
        logits, align, dec_state = step_grouped(
            dec_params, dcfg, wv, dec_state, memory, k, dtype=dtype)
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = logp.reshape(batch, k, vocab)
        # finished beams: lock to EOS with zero added log-prob
        logp = torch.where(finished[:, :, None], locked, logp)

        total = log_probs[:, :, None] + logp  # (B, K, V)
        live = (~finished).to(torch.int32)[:, :, None]
        new_lengths = lengths[:, :, None] + live * not_eos
        scores = total / _length_penalty(new_lengths, length_penalty)

        flat = scores.reshape(batch, k * vocab)
        sorted_scores, order = torch.sort(flat, dim=1, descending=True,
                                          stable=True)
        sel_scores, top_idx = sorted_scores[:, :k], order[:, :k]
        parent = top_idx // vocab
        token = top_idx % vocab

        log_probs = total.reshape(batch, k * vocab).gather(1, top_idx)
        was_finished = finished.gather(1, parent)
        lengths = (lengths.gather(1, parent)
                   + (~was_finished).to(torch.int32))
        finished = was_finished | (token == dcfg.end_id)
        dec_state = _gather_beams(dec_state, parent, batch, k)
        tokens.append(torch.where(was_finished, dcfg.end_id, token))
        parents.append(parent)
        if collect_alignments:
            aligns.append(align.float())  # (B, K, H, L)
        prev = token

    if stopped_at < max_steps:
        # the full-length loop would have kept re-scoring the frozen beams
        # as locked EOS candidates: log-prob unchanged, penalty on the
        # carried (EOS-counted) length
        final_scores = log_probs / _length_penalty(lengths, length_penalty)
    else:
        final_scores = sel_scores
    # unwritten tail steps are (EOS, identity parent): backtrack no-ops
    n = len(tokens)
    identity = torch.arange(k, device=device).expand(batch, k)
    tok_buf = torch.stack(tokens + [torch.full_like(identity, dcfg.end_id)]
                          * (max_steps - n))
    par_buf = torch.stack(parents + [identity] * (max_steps - n))

    _, order = torch.sort(-final_scores, dim=1, stable=True)  # (B, K)
    scores_sorted = final_scores.gather(1, order)
    lengths_sorted = lengths.gather(1, order)

    # parent-pointer backtrack: all K sequences in sorted order
    beam_idx = order
    toks_rev, pars_rev = [], []
    for t in range(max_steps - 1, -1, -1):
        toks_rev.append(tok_buf[t].gather(1, beam_idx))
        beam_idx = par_buf[t].gather(1, beam_idx)
        pars_rev.append(beam_idx)
    ids_sorted = torch.stack(toks_rev[::-1], dim=2).to(torch.int32)

    if collect_alignments:
        # step t's alignment on the top path was computed for the beam that
        # is the parent of the step-t choice
        path_prev = torch.stack(pars_rev[::-1])[:, :, 0]  # (T, B)
        align_buf = torch.stack(aligns)  # (T, B, K, H, L)
        idx = path_prev[:, :, None, None, None].expand(
            -1, -1, 1, heads, mem_len)
        align_top = align_buf.gather(2, idx)[:, :, 0]  # (T, B, H, L)
        alignments = align_top.permute(1, 2, 0, 3)  # (B, H, T, L)
    else:
        alignments = torch.zeros((batch, heads, max_steps, mem_len),
                                 device=device)

    top = DecodeOutput(ids=ids_sorted[:, 0], scores=scores_sorted[:, 0],
                       alignments=alignments, lengths=lengths_sorted[:, 0])
    all_beams = {"ids": ids_sorted.transpose(0, 1),
                 "scores": scores_sorted.transpose(0, 1)}
    return top, all_beams
