"""MobileNet-V2 image encoder, counterpart of
comic_tpu/models/mobilenet_v2.py (slim mobilenet_v2.py, mobilenet.py,
conv_blocks.py).

A 3x3/2 conv, then inverted-residual blocks (expand 1x1 -> depthwise 3x3
-> project 1x1; the input is added back where the stride is 1 and the
channels match), then a 1x1 conv (Conv_1). relu6 after every conv but the
projection; BN scale=True, eps 0.001, inference mode always. Param keys
are slim's ('Conv', 'expanded_conv', 'expanded_conv_1'..'_16', 'Conv_1'
with expand/depthwise/project subscopes). ``depth_multiplier`` 1.4 is the
registry's mobilenet_v2_140: every channel count through make_divisible(c
* 1.4, 8); ``apply`` reads the widths from the params. Inception
preprocessing, 224 input. NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers
from .mobilenet_v1 import conv_bn_relu6, depthwise_init

Params = Dict[str, Any]

BN_EPS = 0.001
DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 1280

# (expansion t, out channels c, repeats n, first stride s) — the V2 table
_IR_TABLE = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def make_divisible(v: float, divisor: int = 8) -> int:
    """slim conv_blocks._make_divisible: round to the nearest multiple of
    ``divisor``, never dropping more than 10% of the value."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def feature_dim(depth_multiplier: float = 1.0) -> int:
    """The width of Conv_1: scaled like every layer for a multiplier above
    1 (1.4 -> 1792), kept at 1280 below (slim's
    finegrain_classification_mode)."""
    if depth_multiplier <= 1.0:
        return FEATURE_DIM
    return make_divisible(FEATURE_DIM * depth_multiplier)


def _blocks():
    """(name, expansion, out channels, stride) of each inverted residual."""
    out = []
    for t, c, n, s in _IR_TABLE:
        for r in range(n):
            idx = len(out)
            out.append(("expanded_conv" if idx == 0
                        else f"expanded_conv_{idx}", t, c, s if r == 0 else 1))
    return out


def init_params(generator: torch.Generator, depth_multiplier: float = 1.0
                ) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    def depth(c):
        return (c if depth_multiplier == 1.0
                else make_divisible(c * depth_multiplier))

    g = generator
    c0 = depth(32)
    params: Params = {"Conv": layers.conv_bn_init(g, 3, 3, 3, c0, True)}
    cin = c0
    for name, t, c, _ in _blocks():
        cout = depth(c)
        # the expansion width comes from the (multiplied) INPUT channels
        mid = cin if t == 1 else make_divisible(cin * t)
        block: Params = {}
        if t != 1:
            block["expand"] = layers.conv_bn_init(g, 1, 1, cin, mid, True)
        block["depthwise"] = {"depthwise_weights": depthwise_init(g, 3, mid),
                              "BatchNorm": layers.bn_init(mid, True)}
        block["project"] = layers.conv_bn_init(g, 1, 1, mid, cout, True)
        params[name] = block
        cin = cout
    params["Conv_1"] = layers.conv_bn_init(
        g, 1, 1, cin, feature_dim(depth_multiplier), True)
    return params


def inverted_residual(block: Params, x: torch.Tensor, stride: int,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Expand 1x1 (where the block has one), depthwise 3x3, linear project
    1x1; the input is added back where the stride is 1 and the channels
    match."""
    y = x
    if "expand" in block:
        y = conv_bn_relu6(block["expand"], y, 1, dtype)
    y = conv_bn_relu6(block["depthwise"], y, stride, dtype, depthwise=True)
    y = layers.conv_bn(block["project"], y, 1, BN_EPS, dtype, act=None)
    if stride == 1 and x.shape[1] == y.shape[1]:
        y = x + y
    return y


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Conv_1",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = conv_bn_relu6(params["Conv"], images, 2, dtype)
    end_points["Conv"] = net
    for name, _, _, stride in _blocks():
        net = inverted_residual(params[name], net, stride, dtype)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    net = conv_bn_relu6(params["Conv_1"], net, 1, dtype)
    end_points["Conv_1"] = net
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
