"""ResNet-v2 (pre-activation) image encoders (50/101/152), counterpart of
comic_tpu/models/resnet_v2.py (slim resnet_v2.py).

Against v1 (resnet.py, whose padding and stride rules it shares): each
bottleneck BN+relu-preactivates its input; the shortcut projects from the
PREACTIVATED tensor; conv3 has a bias and no BN; the root conv has a bias
and no BN/relu; a final 'postnorm' BN+relu follows block4. Param keys are
slim's (preact/, conv3/biases, postnorm/). BN scale=True, eps 1e-5,
inference mode always. VGG preprocessing; pooled feature (B, 2048). NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers
from .resnet import (BLOCK_DEPTHS, BN_EPS, RESNET_V1_UNITS, strided_conv,
                     subsample, unit_stride)

Params = Dict[str, Any]

RESNET_V2_UNITS = {f"resnet_v2_{n.split('_')[-1]}": u
                   for n, u in RESNET_V1_UNITS.items()}
DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 2048


def _conv_bias_init(g, k, cin, cout):
    return {"weights": layers.conv_kernel(g, k, k, cin, cout),
            "biases": torch.zeros(cout)}


def init_params(generator: torch.Generator, name: str = "resnet_v2_50"
                ) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    g = generator
    # the root conv: no BN (preact nets normalize inside units), a bias
    params: Params = {"conv1": _conv_bias_init(g, 7, 3, 64)}
    cin = 64
    for bi, (n_units, depth) in enumerate(
            zip(RESNET_V2_UNITS[name], BLOCK_DEPTHS), 1):
        block: Params = {}
        cout = depth * 4
        for ui in range(1, n_units + 1):
            unit: Params = {
                "preact": layers.bn_init(cin, True),
                "conv1": layers.conv_bn_init(g, 1, 1, cin, depth, True),
                "conv2": layers.conv_bn_init(g, 3, 3, depth, depth, True),
                "conv3": _conv_bias_init(g, 1, depth, cout),
            }
            if cin != cout:
                unit["shortcut"] = _conv_bias_init(g, 1, cin, cout)
            block[f"unit_{ui}"] = {"bottleneck_v2": unit}
            cin = cout
        params[f"block{bi}"] = block
    params["postnorm"] = layers.bn_init(cin, True)
    return params


def _bn_relu(bn, x):
    return torch.relu(layers.frozen_bn(x, bn, BN_EPS))


def _conv(p, x, stride, dtype=None):
    y = strided_conv(x, p["weights"], stride, dtype)
    if "biases" in p:
        return y + p["biases"].view(1, -1, 1, 1)
    return _bn_relu(p["BatchNorm"], y)


def _bottleneck_v2(p: Params, x: torch.Tensor, stride: int, dtype=None
                   ) -> torch.Tensor:
    preact = _bn_relu(p["preact"], x)
    if "shortcut" in p:
        shortcut = _conv(p["shortcut"], preact, stride, dtype)
    else:
        shortcut = subsample(x, stride)
    y = _conv(p["conv1"], preact, 1, dtype)
    y = _conv(p["conv2"], y, stride, dtype)
    y = _conv(p["conv3"], y, 1, dtype)
    return shortcut + y


def apply(params: Params, images: torch.Tensor, name: str = "resnet_v2_50",
          final_endpoint: str = "postnorm",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) mean-subtracted -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = _conv(params["conv1"], images, 2, dtype)
    end_points["conv1"] = net
    net = layers.max_pool(net, 3, 2)
    end_points["pool1"] = net
    units = RESNET_V2_UNITS[name]
    for bi, n_units in enumerate(units, 1):
        bname = f"block{bi}"
        for ui in range(1, n_units + 1):
            net = _bottleneck_v2(
                params[bname][f"unit_{ui}"]["bottleneck_v2"], net,
                unit_stride(bi, ui, n_units), dtype)
        end_points[bname] = net
        if bname == final_endpoint:
            return net, end_points
    net = _bn_relu(params["postnorm"], net)
    end_points["postnorm"] = net
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
