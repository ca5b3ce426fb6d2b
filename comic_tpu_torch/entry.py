"""Entry point: the XE forward on the flagship model, with example args;
counterpart of comic_tpu's ``__graft_entry__.entry``.

The flagship is COMIC-256: the Inception-V1 encoder and the radix-256,
8-head, tied-projection attention-LSTM decoder (LSTM 512, word size 256).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import DeviceLike, resolve_device
from .configuration import Config
from .models.captioner import ModelSpec, build_model_spec, init_params
from .models.captioner import xe_forward
from .params import from_jax_tree
from .tokenization import Vocabulary


def standin_vocab(num_words: int = 50) -> Vocabulary:
    """Small stand-in vocabulary with the reference id layout (PAD=-1,
    words, UNK/GO/EOS): the radix softmax size depends only on the base,
    so a stand-in serves the flagship's widths."""
    wtoi = {"<PAD>": -1}
    for i in range(num_words):
        wtoi[f"w{i}"] = i
    wtoi.update({"<UNK>": num_words, "<GO>": num_words + 1,
                 "<EOS>": num_words + 2})
    return Vocabulary(wtoi)


def flagship(tiny: bool = False) -> Tuple[Config, ModelSpec]:
    """COMIC-256's configuration (reference defaults) and model spec;
    ``tiny`` narrows it for tests as comic_tpu's ``_flagship(tiny=True)``
    does (float32, 64x64 inputs, no dropout)."""
    kw = dict(token_type="radix", radix_base=256, attn_num_heads=8,
              cnn_fm_projection="tied", rnn_size=512, rnn_word_size=256)
    if tiny:
        kw.update(rnn_size=32, rnn_word_size=16, attn_num_heads=2,
                  radix_base=16, compute_dtype="float32",
                  cnn_input_size=(64, 64), dropout_rnn_in=0.0,
                  dropout_rnn_out=0.0, attn_keep_prob=1.0)
    config = Config(**kw)
    return config, build_model_spec(config, standin_vocab())


def entry(device: DeviceLike = None, *, tiny: bool = False,
          params: Optional[Dict[str, Any]] = None, seed: int = 0,
          ) -> Tuple[Callable, Tuple]:
    """-> (fn, example_args): ``fn(params, images, captions)`` is the XE
    forward (no dropout) and returns (loss, logits); the example args are
    the weights, a batch of 8 zero images at the input size (224x224, or
    64x64 when ``tiny``; NCHW) and captions of GO, 20 zero digits and EOS.

    The weights are seeded (``seed``, through an explicit torch.Generator),
    or ``params``: a comic_tpu parameter tree (numpy, comic_tpu's layout)
    carried over by ``params.from_jax_tree``. On the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    config, spec = flagship(tiny)
    if params is None:
        weights = init_params(spec, torch.Generator().manual_seed(seed),
                              device=device)
    else:
        weights = from_jax_tree(params, device)

    def forward(params, images, captions):
        loss, aux = xe_forward(params, spec, images, captions,
                               training=False)
        return loss, aux["logits"]

    batch = 8
    h, w = config.cnn_input_size
    images = torch.zeros((batch, 3, h, w), device=device)
    dec = spec.decoder
    captions = torch.cat(
        [torch.full((batch, 1), dec.start_id, dtype=torch.int32),
         torch.zeros((batch, 20), dtype=torch.int32),
         torch.full((batch, 1), dec.end_id, dtype=torch.int32)],
        dim=1).to(device)
    return forward, (weights, images, captions)
