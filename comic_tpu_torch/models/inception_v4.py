"""Inception-V4 image encoder, counterpart of
comic_tpu/models/inception_v4.py (slim inception_v4).

Table-driven like inception_v3 (whose mixed-block code it shares): a stem
with VALID paddings and the branching stem blocks Mixed_3a/4a/5a, 4x
inception-A, reduction-A, 7x inception-B, reduction-B, 3x inception-C.
Param keys are slim's scope names. BN scale=False, eps 0.001, inference
mode always. The pooled feature is the global average of Mixed_7d
(B, 1536). Default input 299x299, inception preprocessing. NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers
from .inception_v3 import apply_mixed_block, conv_bn_relu, init_block

Params = Dict[str, Any]

DEFAULT_IMAGE_SIZE = 299
FEATURE_DIM = 1536

_S = "SAME"
_V = "VALID"


def _c(scope, cout, kh, kw, stride=1, padding=_S):
    return ("conv", scope, cout, (kh, kw), stride, padding)


_BLOCK_A = [
    [_c("Conv2d_0a_1x1", 96, 1, 1)],
    [_c("Conv2d_0a_1x1", 64, 1, 1), _c("Conv2d_0b_3x3", 96, 3, 3)],
    [_c("Conv2d_0a_1x1", 64, 1, 1), _c("Conv2d_0b_3x3", 96, 3, 3),
     _c("Conv2d_0c_3x3", 96, 3, 3)],
    [("avgpool", "AvgPool_0a_3x3", 3, 1, _S), _c("Conv2d_0b_1x1", 96, 1, 1)],
]
_REDUCTION_A = [
    [_c("Conv2d_1a_3x3", 384, 3, 3, 2, _V)],
    [_c("Conv2d_0a_1x1", 192, 1, 1), _c("Conv2d_0b_3x3", 224, 3, 3),
     _c("Conv2d_1a_3x3", 256, 3, 3, 2, _V)],
    [("maxpool", "MaxPool_1a_3x3", 3, 2, _V)],
]
_BLOCK_B = [
    [_c("Conv2d_0a_1x1", 384, 1, 1)],
    [_c("Conv2d_0a_1x1", 192, 1, 1), _c("Conv2d_0b_1x7", 224, 1, 7),
     _c("Conv2d_0c_7x1", 256, 7, 1)],
    [_c("Conv2d_0a_1x1", 192, 1, 1), _c("Conv2d_0b_7x1", 192, 7, 1),
     _c("Conv2d_0c_1x7", 224, 1, 7), _c("Conv2d_0d_7x1", 224, 7, 1),
     _c("Conv2d_0e_1x7", 256, 1, 7)],
    [("avgpool", "AvgPool_0a_3x3", 3, 1, _S), _c("Conv2d_0b_1x1", 128, 1, 1)],
]
_REDUCTION_B = [
    [_c("Conv2d_0a_1x1", 192, 1, 1), _c("Conv2d_1a_3x3", 192, 3, 3, 2, _V)],
    [_c("Conv2d_0a_1x1", 256, 1, 1), _c("Conv2d_0b_1x7", 256, 1, 7),
     _c("Conv2d_0c_7x1", 320, 7, 1), _c("Conv2d_1a_3x3", 320, 3, 3, 2, _V)],
    [("maxpool", "MaxPool_1a_3x3", 3, 2, _V)],
]
_BLOCK_C = [
    [_c("Conv2d_0a_1x1", 256, 1, 1)],
    [_c("Conv2d_0a_1x1", 384, 1, 1),
     ("fanout", [_c("Conv2d_0b_1x3", 256, 1, 3),
                 _c("Conv2d_0c_3x1", 256, 3, 1)])],
    [_c("Conv2d_0a_1x1", 384, 1, 1), _c("Conv2d_0b_3x1", 448, 3, 1),
     _c("Conv2d_0c_1x3", 512, 1, 3),
     ("fanout", [_c("Conv2d_0d_1x3", 256, 1, 3),
                 _c("Conv2d_0e_3x1", 256, 3, 1)])],
    [("avgpool", "AvgPool_0a_3x3", 3, 1, _S), _c("Conv2d_0b_1x1", 256, 1, 1)],
]

# stem branching blocks
_MIXED_3A = [
    [("maxpool", "MaxPool_0a_3x3", 3, 2, _V)],
    [_c("Conv2d_0a_3x3", 96, 3, 3, 2, _V)],
]
_MIXED_4A = [
    [_c("Conv2d_0a_1x1", 64, 1, 1), _c("Conv2d_1a_3x3", 96, 3, 3, 1, _V)],
    [_c("Conv2d_0a_1x1", 64, 1, 1), _c("Conv2d_0b_1x7", 64, 1, 7),
     _c("Conv2d_0c_7x1", 64, 7, 1), _c("Conv2d_1a_3x3", 96, 3, 3, 1, _V)],
]
_MIXED_5A = [
    [_c("Conv2d_1a_3x3", 192, 3, 3, 2, _V)],
    [("maxpool", "MaxPool_1a_3x3", 3, 2, _V)],
]


def _blocks() -> List[Tuple[str, list]]:
    out = [("Mixed_3a", _MIXED_3A), ("Mixed_4a", _MIXED_4A),
           ("Mixed_5a", _MIXED_5A)]
    out += [(f"Mixed_5{c}", _BLOCK_A) for c in "bcde"]
    out.append(("Mixed_6a", _REDUCTION_A))
    out += [(f"Mixed_6{c}", _BLOCK_B) for c in "bcdefgh"]
    out.append(("Mixed_7a", _REDUCTION_B))
    out += [(f"Mixed_7{c}", _BLOCK_C) for c in "bcd"]
    return out


_STEM = [
    ("Conv2d_1a_3x3", 32, 3, 2, _V),
    ("Conv2d_2a_3x3", 32, 3, 1, _V),
    ("Conv2d_2b_3x3", 64, 3, 1, _S),
]


def init_params(generator: torch.Generator) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    params: Params = {}
    cin = 3
    for name, cout, k, _, _ in _STEM:
        params[name] = layers.conv_bn_init(generator, k, k, cin, cout)
        cin = cout
    for name, branches in _blocks():
        params[name], cin = init_block(generator, branches, cin)
    return params


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Mixed_7d",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = images
    for name, _, _, stride, padding in _STEM:
        net = conv_bn_relu(params[name], net, stride, padding, dtype)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    for name, branches in _blocks():
        net = apply_mixed_block(params[name], branches, net, dtype)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    # slim's inception_v4 raises for unknown endpoints, as comic_tpu does
    raise ValueError(f"Unknown inception_v4 endpoint {final_endpoint!r}")


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
