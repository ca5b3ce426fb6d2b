"""ResNet-v1 image encoders (50/101/152), counterpart of
comic_tpu/models/resnet.py (slim resnet_v1.py + resnet_utils.py).

  - the root is a 7x7/2 conv + BN + relu and a SAME 3x3/2 max pool;
  - a strided conv uses slim's ``conv2d_same``: a FIXED (k-1)//2 /
    (k-1)-(k-1)//2 pad on both sides, then VALID (resnet_utils.py:77-122).
    That is not TF's SAME rule (layers.conv2d's "SAME", which pads k-stride
    in total, the odd pixel after): the two differ on even inputs. Stride
    1 is plain SAME;
  - each bottleneck is 1x1 -> 3x3 (stride) -> 1x1 with BN after every
    conv, relu on the first two, and relu(residual + shortcut) at the end;
  - the stride sits on the LAST unit of blocks 1-3 (slim's convention);
  - BN scale=True, eps 1e-5, inference mode always;
  - the pooled feature is the global average of block4 (B, 2048).

Param keys are slim's (block{i}/unit_{j}/bottleneck_v1/{shortcut,conv1..3}).
VGG preprocessing (mean-subtracted 0-255 RGB). Feature maps are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers

Params = Dict[str, Any]

BN_EPS = 1e-5

# name -> per-block unit counts
RESNET_V1_UNITS = {
    "resnet_v1_50": (3, 4, 6, 3),
    "resnet_v1_101": (3, 4, 23, 3),
    "resnet_v1_152": (3, 8, 36, 3),
}
BLOCK_DEPTHS = (64, 128, 256, 512)  # bottleneck inner depths
DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 2048


def slim_padding(k: int, stride: int):
    """slim's conv2d_same padding for a k x k kernel: "SAME" at stride 1,
    else the fixed pad pairs (applied before a VALID conv)."""
    if stride == 1:
        return "SAME"
    lo = (k - 1) // 2
    return ((lo, k - 1 - lo),) * 2


def strided_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """conv_f32 with slim's conv2d_same padding."""
    return layers.conv_f32(x, w, stride, slim_padding(w.shape[2], stride),
                           dtype)


def subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The identity shortcut of a strided unit: every stride-th pixel."""
    return x[:, :, ::stride, ::stride] if stride > 1 else x


def init_params(generator: torch.Generator, name: str = "resnet_v1_50"
                ) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    g = generator
    params: Params = {"conv1": layers.conv_bn_init(g, 7, 7, 3, 64, True)}
    cin = 64
    for bi, (n_units, depth) in enumerate(
            zip(RESNET_V1_UNITS[name], BLOCK_DEPTHS), 1):
        block: Params = {}
        cout = depth * 4
        for ui in range(1, n_units + 1):
            unit: Params = {
                "conv1": layers.conv_bn_init(g, 1, 1, cin, depth, True),
                "conv2": layers.conv_bn_init(g, 3, 3, depth, depth, True),
                "conv3": layers.conv_bn_init(g, 1, 1, depth, cout, True),
            }
            if cin != cout:
                unit["shortcut"] = layers.conv_bn_init(g, 1, 1, cin, cout,
                                                       True)
            block[f"unit_{ui}"] = {"bottleneck_v1": unit}
            cin = cout
        params[f"block{bi}"] = block
    return params


def _conv_bn(p, x, stride, dtype=None, relu=True):
    y = layers.frozen_bn(strided_conv(x, p["weights"], stride, dtype),
                         p["BatchNorm"], BN_EPS)
    return torch.relu(y) if relu else y


def _bottleneck(p: Params, x: torch.Tensor, stride: int, dtype=None
                ) -> torch.Tensor:
    if "shortcut" in p:
        shortcut = _conv_bn(p["shortcut"], x, stride, dtype, relu=False)
    else:
        shortcut = subsample(x, stride)
    y = _conv_bn(p["conv1"], x, 1, dtype)
    y = _conv_bn(p["conv2"], y, stride, dtype)
    y = _conv_bn(p["conv3"], y, 1, dtype, relu=False)
    return torch.relu(shortcut + y)


def unit_stride(bi: int, ui: int, n_units: int) -> int:
    """slim: stride 2 on the LAST unit of blocks 1-3."""
    return 2 if (ui == n_units and bi < 4) else 1


def apply(params: Params, images: torch.Tensor, name: str = "resnet_v1_50",
          final_endpoint: str = "block4",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) mean-subtracted -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = _conv_bn(params["conv1"], images, 2, dtype)
    end_points["conv1"] = net
    net = layers.max_pool(net, 3, 2)
    end_points["pool1"] = net
    units = RESNET_V1_UNITS[name]
    for bi, n_units in enumerate(units, 1):
        bname = f"block{bi}"
        for ui in range(1, n_units + 1):
            net = _bottleneck(params[bname][f"unit_{ui}"]["bottleneck_v1"],
                              net, unit_stride(bi, ui, n_units), dtype)
        end_points[bname] = net
        if bname == final_endpoint:
            return net, end_points
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
