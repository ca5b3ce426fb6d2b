"""Inception-V2 image encoder, counterpart of
comic_tpu/models/inception_v2.py (slim inception_v2).

A separable 7x7/2 stem (depthwise with channel multiplier 8 over the 3
input channels, then a pointwise conv to 64, inception_v2.py:107-126) and
ten inception blocks (b0: 1x1 / b1: 1x1->3x3 / b2: 1x1->3x3->3x3 / b3:
pool->1x1), two of them stride-2 reductions (Mixed_4a, Mixed_5a). Param
keys are slim's scope names. BN scale=False, eps 0.001, inference mode
always. The pooled feature is the global average of Mixed_5c (B, 1024).
224x224 input, inception preprocessing. Feature maps are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers
from .inception_v1 import BN_EPS

Params = Dict[str, Any]

DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 1024
_DW_MULT = 8

# standard block: (b0, (b1a, b1b), (b2a, b2b), (pool_kind, b3))
_STD = {
    "Mixed_3b": (64, (64, 64), (64, 96), ("avg", 32)),
    "Mixed_3c": (64, (64, 96), (64, 96), ("avg", 64)),
    "Mixed_4b": (224, (64, 96), (96, 128), ("avg", 128)),
    "Mixed_4c": (192, (96, 128), (96, 128), ("avg", 128)),
    "Mixed_4d": (160, (128, 160), (128, 160), ("avg", 96)),
    "Mixed_4e": (96, (128, 192), (160, 192), ("avg", 96)),
    "Mixed_5b": (352, (192, 320), (160, 224), ("avg", 128)),
    "Mixed_5c": (352, (192, 320), (192, 224), ("max", 128)),
}
# reduction block: ((r0a, r0b), (r1a, r1b)) -- both end stride-2; plus maxpool
_REDUCE = {
    "Mixed_4a": ((128, 160), (64, 96)),
    "Mixed_5a": ((128, 192), (192, 256)),
}
_ORDER = ["Mixed_3b", "Mixed_3c", "Mixed_4a", "Mixed_4b", "Mixed_4c",
          "Mixed_4d", "Mixed_4e", "Mixed_5a", "Mixed_5b", "Mixed_5c"]


def _truncated_normal(generator: torch.Generator, shape) -> torch.Tensor:
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t


def init_params(generator: torch.Generator) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    g = generator
    ck = layers.conv_bn_init
    params: Params = {
        "Conv2d_1a_7x7": {
            # (cin, mult, k, k) and OIHW, 0.1 x truncated normal
            "depthwise_weights": 0.1 * _truncated_normal(
                g, (3, _DW_MULT, 7, 7)),
            "pointwise_weights": 0.1 * _truncated_normal(
                g, (64, 3 * _DW_MULT, 1, 1)),
            "BatchNorm": layers.bn_init(64),
        },
        "Conv2d_2b_1x1": ck(g, 1, 1, 64, 64),
        "Conv2d_2c_3x3": ck(g, 3, 3, 64, 192),
    }
    cin = 192
    for name in _ORDER:
        if name in _REDUCE:
            (r0a, r0b), (r1a, r1b) = _REDUCE[name]
            block = {
                "Branch_0": {"Conv2d_0a_1x1": ck(g, 1, 1, cin, r0a),
                             "Conv2d_1a_3x3": ck(g, 3, 3, r0a, r0b)},
                "Branch_1": {"Conv2d_0a_1x1": ck(g, 1, 1, cin, r1a),
                             "Conv2d_0b_3x3": ck(g, 3, 3, r1a, r1b),
                             "Conv2d_1a_3x3": ck(g, 3, 3, r1b, r1b)},
            }
            cout = r0b + r1b + cin
        else:
            b0, (b1a, b1b), (b2a, b2b), (_, b3) = _STD[name]
            block = {
                "Branch_0": {"Conv2d_0a_1x1": ck(g, 1, 1, cin, b0)},
                "Branch_1": {"Conv2d_0a_1x1": ck(g, 1, 1, cin, b1a),
                             "Conv2d_0b_3x3": ck(g, 3, 3, b1a, b1b)},
                "Branch_2": {"Conv2d_0a_1x1": ck(g, 1, 1, cin, b2a),
                             "Conv2d_0b_3x3": ck(g, 3, 3, b2a, b2b),
                             "Conv2d_0c_3x3": ck(g, 3, 3, b2b, b2b)},
                "Branch_3": {"Conv2d_0b_1x1": ck(g, 1, 1, cin, b3)},
            }
            cout = b0 + b1b + b2b + b3
        params[name] = block
        cin = cout
    return params


def _conv(p, x, stride, dtype):
    return layers.conv_bn(p, x, stride, BN_EPS, dtype)


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Mixed_5c",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    # separable stem: the depthwise conv's float32 output is rounded to the
    # compute dtype again for the pointwise conv, as in comic_tpu
    p = params["Conv2d_1a_7x7"]
    y = layers.conv_f32(images, layers.depthwise_kernel(p["depthwise_weights"]),
                        2, "SAME", dtype, groups=images.shape[1])
    y = layers.conv_f32(y, p["pointwise_weights"], 1, "SAME", dtype)
    net = torch.relu(layers.frozen_bn(y, p["BatchNorm"], BN_EPS))
    end_points["Conv2d_1a_7x7"] = net
    net = layers.max_pool(net, 3, 2)
    end_points["MaxPool_2a_3x3"] = net
    net = _conv(params["Conv2d_2b_1x1"], net, 1, dtype)
    end_points["Conv2d_2b_1x1"] = net
    net = _conv(params["Conv2d_2c_3x3"], net, 1, dtype)
    end_points["Conv2d_2c_3x3"] = net
    net = layers.max_pool(net, 3, 2)
    end_points["MaxPool_3a_3x3"] = net

    for name in _ORDER:
        block = params[name]
        # the input-side 1x1 convs run as one merged conv, as in comic_tpu
        if name in _REDUCE:
            b0, b1 = layers.merged_1x1_bn_relu(
                [block["Branch_0"]["Conv2d_0a_1x1"],
                 block["Branch_1"]["Conv2d_0a_1x1"]], net, BN_EPS, dtype)
            b0 = _conv(block["Branch_0"]["Conv2d_1a_3x3"], b0, 2, dtype)
            b1 = _conv(block["Branch_1"]["Conv2d_0b_3x3"], b1, 1, dtype)
            b1 = _conv(block["Branch_1"]["Conv2d_1a_3x3"], b1, 2, dtype)
            b2 = layers.max_pool(net, 3, 2)
            net = torch.cat([b0, b1, b2], dim=1)
        else:
            b0, b1, b2 = layers.merged_1x1_bn_relu(
                [block["Branch_0"]["Conv2d_0a_1x1"],
                 block["Branch_1"]["Conv2d_0a_1x1"],
                 block["Branch_2"]["Conv2d_0a_1x1"]], net, BN_EPS, dtype)
            b1 = _conv(block["Branch_1"]["Conv2d_0b_3x3"], b1, 1, dtype)
            b2 = _conv(block["Branch_2"]["Conv2d_0b_3x3"], b2, 1, dtype)
            b2 = _conv(block["Branch_2"]["Conv2d_0c_3x3"], b2, 1, dtype)
            b3 = (layers.avg_pool(net, 3, 1) if _STD[name][3][0] == "avg"
                  else layers.max_pool(net, 3, 1))
            b3 = _conv(block["Branch_3"]["Conv2d_0b_1x1"], b3, 1, dtype)
            net = torch.cat([b0, b1, b2, b3], dim=1)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
