"""MobileNet-V1 image encoder, counterpart of
comic_tpu/models/mobilenet_v1.py (slim mobilenet_v1.py).

A 3x3/2 conv, then 13 separable blocks (a 3x3 depthwise conv, stride 1 or
2, then a 1x1 pointwise conv), each conv followed by BN and relu6. Param
keys are slim's (Conv2d_0, Conv2d_{i}_depthwise, Conv2d_{i}_pointwise).
BN scale=True, eps 0.001, inference mode always. The pooled feature is the
global average of Conv2d_13_pointwise (B, 1024). Inception preprocessing,
224 input. Depthwise kernels are stored (C, 1, 3, 3) (params.py). NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers

Params = Dict[str, Any]

BN_EPS = 0.001
DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 1024

# (stride, output channels) for the 13 separable blocks
_BLOCKS = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
           (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024),
           (1, 1024)]


def depthwise_init(g: torch.Generator, k: int, c: int) -> torch.Tensor:
    """slim's FAN_IN truncated normal for a (k, k, c, 1) depthwise kernel
    (fan k * k * c, as comic_tpu counts it), stored (c, 1, k, k)."""
    return layers.slim_variance_scaling(g, (k, k, c, 1), k * k * c
                                        ).permute(2, 3, 0, 1).contiguous()


def init_params(generator: torch.Generator) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    g = generator
    params: Params = {"Conv2d_0": layers.conv_bn_init(g, 3, 3, 3, 32, True)}
    cin = 32
    for i, (_, cout) in enumerate(_BLOCKS, 1):
        params[f"Conv2d_{i}_depthwise"] = {
            "depthwise_weights": depthwise_init(g, 3, cin),
            "BatchNorm": layers.bn_init(cin, True)}
        params[f"Conv2d_{i}_pointwise"] = layers.conv_bn_init(
            g, 1, 1, cin, cout, True)
        cin = cout
    return params


def conv_bn_relu6(p: Params, x: torch.Tensor, stride: int,
                  dtype: Optional[torch.dtype] = None,
                  depthwise: bool = False) -> torch.Tensor:
    """A conv (a depthwise one over ``p["depthwise_weights"]``), BN and
    relu6."""
    if not depthwise:
        return layers.conv_bn(p, x, stride, BN_EPS, dtype, act=layers.relu6)
    return layers.conv_bn(p, x, stride, BN_EPS, dtype, act=layers.relu6,
                          kernel=layers.depthwise_kernel(
                              p["depthwise_weights"]), groups=x.shape[1])


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Conv2d_13_pointwise",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = conv_bn_relu6(params["Conv2d_0"], images, 2, dtype)
    end_points["Conv2d_0"] = net
    for i, (stride, _) in enumerate(_BLOCKS, 1):
        net = conv_bn_relu6(params[f"Conv2d_{i}_depthwise"], net, stride,
                            dtype, depthwise=True)
        end_points[f"Conv2d_{i}_depthwise"] = net
        net = conv_bn_relu6(params[f"Conv2d_{i}_pointwise"], net, 1, dtype)
        ep = f"Conv2d_{i}_pointwise"
        end_points[ep] = net
        if ep == final_endpoint:
            return net, end_points
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
