"""Attention-LSTM caption decoder; counterpart of
comic_tpu/models/decoder.py (reference model_base.py:109-314,531-757).

``step`` is the flat decode step (greedy, and teacher forcing with
train-time dropout), ``step_grouped`` the beam-grouped one, whose attention
reads each image's memory once for all its beams, and ``teacher_forced``
the training decode over a whole (B, T) batch of inputs.

comic_tpu's teacher-forced scan rematerializes each step in the backward
pass (``jax.checkpoint``), a memory device of XLA's. The port keeps every
step's activations for autograd instead: at full COMIC-256 width (batch
32, 42 steps) a decoder-stage train step peaks at 3.3 GiB on an H100
80GB HBM3 at 700 W (``chip_smoke.py``, PERF.md).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .attention import (
    AttentionConfig,
    AttentionMemory,
    attend,
    attend_grouped,
    attention_init,
    precompute,
)
from .cells import Cell, apply_dropout
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


class DropoutMasks(NamedTuple):
    """Train-time dropout of one decode, drawn before it runs. The per-step
    keep masks are bool with a leading time axis (T, B, ...) in a whole
    decode and without it in a step; the variational noise (0 or
    1/keep_prob, one per sequence) is the same at every step. None: that
    dropout is off."""

    keep_in: Optional[torch.Tensor] = None  # (T, B, rnn_input_size)
    keep_out: Optional[torch.Tensor] = None  # (T, B, rnn_size)
    keep_align: Optional[torch.Tensor] = None  # (T, B, H, L)
    noise_in: Optional[torch.Tensor] = None  # (B, rnn_input_size)
    noise_out: Optional[torch.Tensor] = None  # (B, rnn_size)

    def at(self, t: int) -> "DropoutMasks":
        """The masks of step t."""
        return self._replace(**{
            k: getattr(self, k)[t] for k in ("keep_in", "keep_out",
                                             "keep_align")
            if getattr(self, k) is not None})

    def rows(self, start: int, count: int) -> "DropoutMasks":
        """The masks of batch rows [start, start + count) of a decode."""
        rows = slice(start, start + count)
        return self._replace(**{
            k: (v[:, rows] if k.startswith("keep") else v[rows])
            for k, v in self._asdict().items() if v is not None})


def draw_dropout_masks(cfg: DecoderConfig, batch: int, steps: int,
                       positions: int, generator: torch.Generator,
                       device: torch.device) -> DropoutMasks:
    """comic_tpu's train-time dropout for a decode of ``steps`` steps over
    ``positions`` attention positions: input and output dropout a step, or
    with ``recurrent_dropout`` one input and one output mask a sequence
    (tf DropoutWrapper(variational_recurrent=True), model_base.py:636-648),
    and alignment dropout inside the attention (ops_rnn.py:696-701)."""
    def keep(shape, prob):
        return torch.rand(shape, generator=generator, device=device) < prob

    def noise(shape, prob):
        return torch.where(keep(shape, prob), 1.0 / prob, 0.0)

    masks = DropoutMasks()
    p_in, p_out = 1.0 - cfg.dropout_in, 1.0 - cfg.dropout_out
    sizes = {"in": cfg.rnn_input_size, "out": cfg.rnn_size}
    for name, prob in (("in", p_in), ("out", p_out)):
        if prob >= 1.0:
            continue
        if cfg.recurrent_dropout:
            masks = masks._replace(
                **{f"noise_{name}": noise((batch, sizes[name]), prob)})
        else:
            masks = masks._replace(
                **{f"keep_{name}": keep((steps, batch, sizes[name]), prob)})
    if cfg.attn_keep_prob < 1.0:
        masks = masks._replace(keep_align=keep(
            (steps, batch, cfg.attention.num_heads, positions),
            cfg.attn_keep_prob))
    return masks


def step(p: Params, cfg: DecoderConfig, word_vec: torch.Tensor,
         state: DecoderState, memory: AttentionMemory, *, dtype=None,
         dropout: Optional[DropoutMasks] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor, DecoderState]:
    """One decode step: cell_in = [word_vec ; prev_context] -> cell -> h;
    context, alignments = attend(h); logits = W_out h + b. ``dropout``
    (one step's masks) is the train-time dropout of the cell's input and
    output and of the alignments.

    Returns (logits (B, softmax), alignments (B, H, L), new_state).
    """
    x = torch.cat([word_vec, state.attention], dim=-1)
    if dropout is not None:
        x = apply_dropout(x, 1.0 - cfg.dropout_in, keep_mask=dropout.keep_in,
                          noise=dropout.noise_in)
    h, cell_state = make_cell(cfg).step(p["cell"], x, state.cell_state,
                                        dtype=dtype)
    if dropout is not None:
        h = apply_dropout(h, 1.0 - cfg.dropout_out,
                          keep_mask=dropout.keep_out, noise=dropout.noise_out)
    context, alignments = attend(
        p["attention"], cfg.attention, h, memory, dtype=dtype,
        alignments_keep_mask=None if dropout is None else dropout.keep_align,
        alignments_keep_prob=cfg.attn_keep_prob)
    logits = dense_apply(p["output_projection"], h, dtype=dtype)
    return logits, alignments, DecoderState(cell_state, context)


def teacher_forced(p: Params, cfg: DecoderConfig, inputs: torch.Tensor,
                   im_embed: torch.Tensor, feature_map: torch.Tensor, *,
                   training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   dropout: Optional[DropoutMasks] = None, dtype=None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode over a (B, T) batch of input ids (reference
    dynamic_decode + TrainingHelper, ops_rnn.py:183-243).

    ``training`` turns on dropout: the masks ``dropout`` when given, else
    masks drawn from ``generator``. Returns (logits (B, T, softmax),
    alignments (B, T, H, L)).
    """
    memory = precompute(p["attention"], cfg.attention, feature_map,
                        dtype=dtype)
    state = initial_state(p, cfg, im_embed, dtype=dtype)
    word_vecs = embed_ids(p, cfg, inputs, dtype=dtype)  # (B, T, word)
    batch, steps = inputs.shape
    if training and dropout is None:
        dropout = draw_dropout_masks(cfg, batch, steps, memory.keys.shape[1],
                                     generator, inputs.device)
    if not training:
        dropout = None
    logits, alignments = [], []
    for t in range(steps):
        lg, al, state = step(
            p, cfg, word_vecs[:, t], state, memory, dtype=dtype,
            dropout=None if dropout is None else dropout.at(t))
        logits.append(lg)
        alignments.append(al)
    return torch.stack(logits, dim=1), torch.stack(alignments, dim=1)


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
