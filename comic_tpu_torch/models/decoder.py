"""Attention-LSTM caption decoder, inference part; counterpart of
comic_tpu/models/decoder.py (reference model_base.py:109-314,531-757).

``step`` is the flat decode step (greedy) and ``step_grouped`` the
beam-grouped one, whose attention reads each image's memory once for all
its beams. Train-time dropout and the teacher-forced decode wait for the
training slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from .attention import (
    AttentionConfig,
    AttentionMemory,
    attend,
    attend_grouped,
    attention_init,
)
from .cells import Cell
from .layers import dense_apply, dense_init, get_initializer, matmul_f32

Params = Dict[str, Any]


class DecoderConfig(NamedTuple):
    token_type: str  # radix | word | char
    softmax_size: int  # radix_base + 2 for radix, len(itow) otherwise
    rnn_name: str = "LSTM"
    rnn_size: int = 512
    word_size: int = 256
    init_method: str = "first_input"  # first_input | project_hidden
    image_embed_size: int = 1024  # pooled CNN feature size
    attention: AttentionConfig = None
    # dropout (train-time)
    dropout_in: float = 0.35
    dropout_out: float = 0.35
    recurrent_dropout: bool = False
    attn_keep_prob: float = 0.9
    # special token ids in the decode plane (model_base.py:700-707)
    start_id: int = 256
    end_id: int = 257
    initialiser: str = "xavier"

    @property
    def rnn_input_size(self) -> int:
        return self.word_size + self.attention.context_size


class DecoderState(NamedTuple):
    """Carried through every decode step."""

    cell_state: Any  # LSTMState or tensor (GRU)
    attention: torch.Tensor  # (B, context_size) previous context vector


def make_cell(cfg: DecoderConfig) -> Cell:
    return Cell(cfg.rnn_name, cfg.rnn_input_size, cfg.rnn_size)


def decoder_init(generator: torch.Generator, cfg: DecoderConfig) -> Params:
    """The decoder parameter tree (same keys and distributions as
    comic_tpu's decoder_init)."""
    init = get_initializer(cfg.initialiser)
    p: Params = {
        "embedding": init(generator, (cfg.softmax_size, cfg.word_size)),
        "output_projection": dense_init(
            generator, cfg.rnn_size, cfg.softmax_size, use_bias=True,
            init=init),
        "cell": make_cell(cfg).init(generator, init),
        "attention": attention_init(generator, cfg.attention, init),
    }
    if cfg.init_method == "project_hidden":
        p["rnn_initial_state"] = dense_init(
            generator, cfg.image_embed_size, cfg.rnn_size, use_bias=False,
            init=init)
    elif cfg.init_method == "first_input":
        p["rnn_init_input"] = dense_init(
            generator, cfg.image_embed_size, cfg.rnn_input_size,
            use_bias=False, init=init)
    else:
        raise ValueError(f"Invalid rnn_init_method: {cfg.init_method}")
    return p


def embed_ids(p: Params, cfg: DecoderConfig, ids: torch.Tensor,
              dtype=None) -> torch.Tensor:
    """ids -> word vectors.

    Radix/char vocabularies are tiny, so the lookup is a one-hot matmul
    (model_base.py:574-594). The one-hot is built by comparison, so a
    negative id (<PAD> = -1) embeds as a zero row, as jax.nn.one_hot gives;
    ``F.one_hot`` would raise on it. Word vocabularies gather, with
    negative ids clipped to 0.
    """
    table = p["embedding"]
    if cfg.token_type == "word":
        return table[ids.clamp(min=0)]
    classes = torch.arange(cfg.softmax_size, device=ids.device)
    onehot = (ids[..., None] == classes).to(table.dtype)
    return matmul_f32(onehot, table, dtype)


def initial_state(p: Params, cfg: DecoderConfig, im_embed: torch.Tensor,
                  dtype=None) -> DecoderState:
    """The decoder's initial state from the pooled image embedding."""
    cell = make_cell(cfg)
    batch = im_embed.shape[0]
    if cfg.init_method == "project_hidden":
        h = dense_apply(p["rnn_initial_state"], im_embed, dtype=dtype)
        cell_state = cell.state_from_hidden(h)
    else:  # first_input: run the cell once on the projected embedding
        x0 = dense_apply(p["rnn_init_input"], im_embed, dtype=dtype)
        _, cell_state = cell.step(p["cell"], x0,
                                  cell.zero_state(batch, im_embed.device),
                                  dtype=dtype)
    attn0 = torch.zeros((batch, cfg.attention.context_size),
                        device=im_embed.device)
    return DecoderState(cell_state=cell_state, attention=attn0)


def step(p: Params, cfg: DecoderConfig, word_vec: torch.Tensor,
         state: DecoderState, memory: AttentionMemory, *, dtype=None,
         ) -> Tuple[torch.Tensor, torch.Tensor, DecoderState]:
    """One decode step, inference: cell_in = [word_vec ; prev_context] ->
    cell -> h; context, alignments = attend(h); logits = W_out h + b.

    Returns (logits (B, softmax), alignments (B, H, L), new_state).
    """
    x = torch.cat([word_vec, state.attention], dim=-1)
    h, cell_state = make_cell(cfg).step(p["cell"], x, state.cell_state,
                                        dtype=dtype)
    context, alignments = attend(p["attention"], cfg.attention, h, memory,
                                 dtype=dtype)
    logits = dense_apply(p["output_projection"], h, dtype=dtype)
    return logits, alignments, DecoderState(cell_state, context)


def step_grouped(p: Params, cfg: DecoderConfig, word_vec: torch.Tensor,
                 state: DecoderState, memory: AttentionMemory, k: int, *,
                 dtype=None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, DecoderState]:
    """Beam-grouped decode step: rows are (B*K) hypotheses, the memory is
    the UNtiled per-image attention memory."""
    x = torch.cat([word_vec, state.attention], dim=-1)
    h, cell_state = make_cell(cfg).step(p["cell"], x, state.cell_state,
                                        dtype=dtype)
    b = memory.keys.shape[0]
    context, alignments = attend_grouped(
        p["attention"], cfg.attention, h.reshape(b, k, -1), memory,
        dtype=dtype)
    logits = dense_apply(p["output_projection"], h, dtype=dtype)
    return (logits, alignments,
            DecoderState(cell_state, context.reshape(b * k, -1)))
