"""Recurrent cells as step functions plus train-time dropout, counterpart
of comic_tpu/models/cells.py (reference model_base.py:606-648).

The gate matmul is one (in + hidden, 4 * hidden) product; operands are
rounded to the compute dtype and multiplied in float32 (layers.matmul_f32).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .layers import layer_norm_apply, layer_norm_init, matmul_f32, xavier_uniform

Params = Dict[str, Any]


class LSTMState(NamedTuple):
    c: torch.Tensor
    h: torch.Tensor


# --- LSTM (tf BasicLSTMCell: gate order i, j, f, o; forget_bias=1.0) -------

def lstm_init(generator: torch.Generator, input_size: int, num_units: int,
              init=xavier_uniform) -> Params:
    return {
        "kernel": init(generator, (input_size + num_units, 4 * num_units)),
        "bias": torch.zeros(4 * num_units),
    }


def lstm_step(p: Params, x: torch.Tensor, state: LSTMState,
              forget_bias: float = 1.0, dtype=None
              ) -> Tuple[torch.Tensor, LSTMState]:
    xc = torch.cat([x, state.h], dim=-1)
    gates = matmul_f32(xc, p["kernel"], dtype) + p["bias"]
    i, j, f, o = gates.chunk(4, dim=-1)
    new_c = (state.c * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, LSTMState(new_c, new_h)


# --- LayerNorm LSTM (tf LayerNormBasicLSTMCell) ----------------------------

def ln_lstm_init(generator: torch.Generator, input_size: int,
                 num_units: int, init=xavier_uniform) -> Params:
    return {
        "kernel": init(generator, (input_size + num_units, 4 * num_units)),
        "ln_i": layer_norm_init(num_units),
        "ln_j": layer_norm_init(num_units),
        "ln_f": layer_norm_init(num_units),
        "ln_o": layer_norm_init(num_units),
        "ln_c": layer_norm_init(num_units),
    }


def ln_lstm_step(p: Params, x: torch.Tensor, state: LSTMState,
                 forget_bias: float = 1.0, dtype=None
                 ) -> Tuple[torch.Tensor, LSTMState]:
    xc = torch.cat([x, state.h], dim=-1)
    gates = matmul_f32(xc, p["kernel"], dtype)
    i, j, f, o = gates.chunk(4, dim=-1)
    i = layer_norm_apply(p["ln_i"], i)
    j = layer_norm_apply(p["ln_j"], j)
    f = layer_norm_apply(p["ln_f"], f)
    o = layer_norm_apply(p["ln_o"], o)
    new_c = (state.c * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(layer_norm_apply(p["ln_c"], new_c)) * torch.sigmoid(o)
    return new_h, LSTMState(new_c, new_h)


# --- GRU (tf GRUCell: gate bias init 1.0) ----------------------------------

def gru_init(generator: torch.Generator, input_size: int, num_units: int,
             init=xavier_uniform) -> Params:
    return {
        "gate_kernel": init(generator, (input_size + num_units,
                                        2 * num_units)),
        "gate_bias": torch.ones(2 * num_units),
        "cand_kernel": init(generator, (input_size + num_units, num_units)),
        "cand_bias": torch.zeros(num_units),
    }


def gru_step(p: Params, x: torch.Tensor, h: torch.Tensor, dtype=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    xc = torch.cat([x, h], dim=-1)
    gates = torch.sigmoid(matmul_f32(xc, p["gate_kernel"], dtype)
                          + p["gate_bias"])
    r, u = gates.chunk(2, dim=-1)
    xrh = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(matmul_f32(xrh, p["cand_kernel"], dtype) + p["cand_bias"])
    new_h = u * h + (1.0 - u) * c
    return new_h, new_h


# --- cell registry ---------------------------------------------------------

class Cell:
    """Bundles init/step/zero-state for a named cell type. State is
    LSTMState(c, h) for the LSTM variants and a bare tensor for the GRU."""

    def __init__(self, name: str, input_size: int, num_units: int):
        if name not in ("LSTM", "LN_LSTM", "GRU"):
            raise ValueError("Only `LSTM`, `LN_LSTM` and `GRU` are accepted.")
        self.name = name
        self.input_size = input_size
        self.num_units = num_units

    def init(self, generator: torch.Generator, init=xavier_uniform) -> Params:
        if self.name == "LSTM":
            return lstm_init(generator, self.input_size, self.num_units, init)
        if self.name == "LN_LSTM":
            return ln_lstm_init(generator, self.input_size, self.num_units,
                                init)
        return gru_init(generator, self.input_size, self.num_units, init)

    def zero_state(self, batch_size: int, device: torch.device):
        z = torch.zeros((batch_size, self.num_units), device=device)
        if self.name == "GRU":
            return z
        return LSTMState(z, z)

    def step(self, p: Params, x, state, dtype=None):
        if self.name == "LSTM":
            return lstm_step(p, x, state, dtype=dtype)
        if self.name == "LN_LSTM":
            return ln_lstm_step(p, x, state, dtype=dtype)
        return gru_step(p, x, state, dtype=dtype)

    def state_from_hidden(self, h: torch.Tensor):
        """`project_hidden` init: h projected, c zeroed."""
        if self.name == "GRU":
            return h
        return LSTMState(torch.zeros_like(h), h)


def apply_dropout(x: torch.Tensor, keep_prob: float, *,
                  keep_mask: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Inverted dropout with tf DropoutWrapper semantics: kept entries are
    divided by ``keep_prob``. ``noise`` is a fixed multiplier (0 or
    1/keep_prob) for variational recurrent dropout, the same at every step
    (model_base.py:641-647); else ``keep_mask`` (bool, x's shape) says
    what is kept, drawn from ``generator`` when not given."""
    if keep_prob >= 1.0:
        return x
    if noise is not None:
        return x * noise
    if keep_mask is None:
        keep_mask = torch.rand(x.shape, generator=generator,
                               device=x.device) < keep_prob
    return torch.where(keep_mask, x / keep_prob, x.new_zeros(()))
