"""The caption model: static spec, parameter tree, losses and the
teacher-forced XE and SCST forwards; counterpart of
comic_tpu/models/captioner.py (reference model.py, model_base.py).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..configuration import Config
from ..tokenization import RadixCodec, Vocabulary
from .attention import AttentionConfig
from .decoder import DecoderConfig, decoder_init, teacher_forced
from .encoders import encode_images, encoder_init, get_encoder

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, None: None}


class ModelSpec(NamedTuple):
    """Static model hyperparameters derived from a Config + vocabulary."""

    cnn_name: str
    fm_endpoint: str
    legacy: bool
    decoder: DecoderConfig
    token_type: str
    radix_base: Optional[int]
    compute_dtype: Optional[torch.dtype]


def softmax_size_for(config: Config, vocab: Vocabulary) -> int:
    """radix: base + 2 digits/GO/EOS rows; else the full vocab
    (model_base.py:39-45)."""
    if config.token_type == "radix":
        return config.radix_base + 2
    return len(vocab.itow)


def start_end_ids(config: Config, vocab: Vocabulary) -> Tuple[int, int]:
    """Decode-plane GO/EOS ids (model_base.py:700-707)."""
    if config.token_type == "radix":
        return config.radix_base, config.radix_base + 1
    return vocab.go_id, vocab.eos_id


def max_decode_steps(config: Config, vocab: Vocabulary) -> int:
    """infer_max_length in decode steps: x digits-per-word for radix, x5
    for char (model_base.py:708-714)."""
    steps = int(config.infer_max_length)
    if config.token_type == "radix":
        steps *= RadixCodec(len(vocab), config.radix_base).word_len
    elif config.token_type == "char":
        steps *= 5
    return steps


def build_model_spec(config: Config, vocab: Vocabulary) -> ModelSpec:
    enc = get_encoder(config.cnn_name)
    fm_endpoint = config.cnn_fm_attention or enc.default_fm_endpoint
    if fm_endpoint not in enc.fm_channels:
        # e.g. the CLI default 'Mixed_4f' with another encoder: fall back to
        # the encoder's own attention endpoint, and record it in the config
        # as comic_tpu does (stderr: stdout may be machine-read)
        print(f"WARNING: endpoint {fm_endpoint} unknown for "
              f"{config.cnn_name}; using {enc.default_fm_endpoint}.",
              file=sys.stderr)
        fm_endpoint = enc.default_fm_endpoint
        config.cnn_fm_attention = fm_endpoint
    attn = AttentionConfig(
        num_units=config.rnn_size,
        num_heads=config.attn_num_heads,
        memory_channels=enc.fm_channels[fm_endpoint],
        alignment=config.attn_alignment_method,
        probability=config.attn_probability_fn,
        fm_projection=config.cnn_fm_projection,
        context_layer=bool(config.attn_context_layer),
    )
    start_id, end_id = start_end_ids(config, vocab)
    dec = DecoderConfig(
        token_type=config.token_type,
        softmax_size=softmax_size_for(config, vocab),
        rnn_name=config.rnn_name,
        rnn_size=config.rnn_size,
        word_size=config.rnn_word_size,
        init_method=config.rnn_init_method,
        image_embed_size=1024 if config.legacy else enc.feature_dim,
        attention=attn,
        dropout_in=config.dropout_rnn_in,
        dropout_out=config.dropout_rnn_out,
        recurrent_dropout=bool(config.rnn_recurr_dropout),
        attn_keep_prob=config.attn_keep_prob,
        start_id=start_id,
        end_id=end_id,
        initialiser=config.get("initialiser") or "xavier",
    )
    return ModelSpec(
        cnn_name=config.cnn_name, fm_endpoint=fm_endpoint,
        legacy=bool(config.legacy), decoder=dec,
        token_type=config.token_type,
        radix_base=config.radix_base if config.token_type == "radix" else None,
        compute_dtype=_DTYPES[config.compute_dtype])


def init_params(spec: ModelSpec, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """The full parameter tree {"encoder", "decoder"}: comic_tpu's keys,
    shapes and distributions, not its bits. Drawn on the CPU from
    ``generator`` (seed 0 when None), so a seed gives the same tree on any
    device, then moved to ``device`` (None: the card)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    tree = {
        "encoder": encoder_init(generator, spec.cnn_name, spec.legacy),
        "decoder": decoder_init(generator, spec.decoder),
    }
    return tree_to(tree, device)


def tree_to(tree, device: torch.device):
    """The same nested dict with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --- input processing (model_base.py:501-528) ------------------------------

def process_captions(captions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T) padded ids -> (inputs, targets, mask): mask is 1 where the
    shifted caption is not <PAD> (-1); targets are clipped at 0 so padded
    positions index row 0 (they are masked); inputs keep the raw ids (the
    one-hot embedding maps -1 to a zero row)."""
    inputs = captions[:, :-1]
    shifted = captions[:, 1:]
    mask = torch.sign((shifted + 1).float())
    return inputs, shifted.clamp(min=0), mask


# --- losses (model_base.py:325-417) ----------------------------------------

def sequence_loss(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, average_across_batch: bool = True
                  ) -> torch.Tensor:
    """Weighted softmax cross-entropy (tf.contrib.seq2seq.sequence_loss):
    with batch averaging sum(xent * w) / sum(w), else per example."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    xent = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if average_across_batch:
        return (xent * weights).sum() / weights.sum().clamp(min=1e-12)
    return (xent * weights).sum(dim=1) / weights.sum(dim=1).clamp(min=1e-12)


def attention_map_loss(alignments: torch.Tensor, scale: float,
                       valid_steps=None) -> torch.Tensor:
    """Doubly-stochastic attention regularizer: the mean of (1 - the sum
    over the HEAD axis of the maps)^2, as the reference computes it
    (model_base.py:355-365). ``alignments`` are (B, T, H, L).
    ``valid_steps`` (int or 0-d tensor) restricts the mean to the first N
    steps: the trainers pass the batch-max caption length, where the
    reference's dynamic_decode stops."""
    if scale <= 0:
        return torch.zeros((), device=alignments.device)
    sq = (1.0 - alignments.sum(dim=2)).square()  # (B, T, L)
    if valid_steps is None:
        return sq.mean() * scale
    b, t, l = sq.shape
    valid = torch.as_tensor(valid_steps, device=sq.device)
    m = (torch.arange(t, device=sq.device) < valid).to(sq.dtype)
    denom = (b * l * valid.to(sq.dtype)).clamp(min=1.0)
    return (sq * m[None, :, None]).sum() / denom * scale


def xe_forward(params: Params, spec: ModelSpec, images: torch.Tensor,
               captions: torch.Tensor, *, training: bool = False,
               generator: Optional[torch.Generator] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced forward -> (log-perplexity loss, aux dict with the
    logits, alignments, mask, targets and loss). ``training`` turns on
    dropout, drawn from ``generator``."""
    im_embed, fmaps = encode_images(
        params["encoder"], images, spec.cnn_name, spec.fm_endpoint,
        legacy=spec.legacy, dtype=spec.compute_dtype)
    inputs, targets, mask = process_captions(captions)
    logits, alignments = teacher_forced(
        params["decoder"], spec.decoder, inputs, im_embed, fmaps,
        training=training, generator=generator, dtype=spec.compute_dtype)
    log_ppl = sequence_loss(logits, targets, mask)
    return log_ppl, {"logits": logits, "alignments": alignments,
                     "mask": mask, "targets": targets, "log_ppl": log_ppl}


def scst_forward(params: Params, spec: ModelSpec, images: torch.Tensor,
                 captions: torch.Tensor, rewards: torch.Tensor, *,
                 training: bool = True,
                 generator: Optional[torch.Generator] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """REINFORCE as reward-weighted XE on sampled captions
    (model_base.py:342-347): the mean over examples of the per-example
    sequence loss x reward -> (loss, aux dict with the alignments, mask
    and loss)."""
    im_embed, fmaps = encode_images(
        params["encoder"], images, spec.cnn_name, spec.fm_endpoint,
        legacy=spec.legacy, dtype=spec.compute_dtype)
    inputs, targets, mask = process_captions(captions)
    logits, alignments = teacher_forced(
        params["decoder"], spec.decoder, inputs, im_embed, fmaps,
        training=training, generator=generator, dtype=spec.compute_dtype)
    per_example = sequence_loss(logits, targets, mask,
                                average_across_batch=False)
    loss = (per_example * rewards).mean()
    return loss, {"alignments": alignments, "mask": mask, "log_ppl": loss}
