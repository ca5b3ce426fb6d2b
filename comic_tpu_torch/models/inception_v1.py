"""Inception-V1 (GoogLeNet) image encoder, counterpart of
comic_tpu/models/inception_v1.py.

The network is the same block table; parameters keep the slim endpoint and
branch names, so one param tree (and one checkpoint) drives both packages.
Feature maps are NCHW here; the endpoint dict carries slim's names
(Conv2d_1a_7x7 ... Mixed_5c). BatchNorm is the frozen inference-mode affine
(scale=False, eps=0.001) in every training stage, as in the reference
(model_base.py:72-76). Convolutions follow TF's SAME padding rule, which is
asymmetric at stride 2 (layers.conv2d / max_pool).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers

Params = Dict[str, Any]

# (name, kind, spec)
#   conv: (filters, kernel, stride)
#   pool: (kernel, stride)  -- max pool, SAME padding
#   mixed: (b0, (b1a, b1b), (b2a, b2b), b3) 1x1/3x3 inception branch filters
_V1_BLOCKS: List[Tuple[str, str, tuple]] = [
    ("Conv2d_1a_7x7", "conv", (64, 7, 2)),
    ("MaxPool_2a_3x3", "pool", (3, 2)),
    ("Conv2d_2b_1x1", "conv", (64, 1, 1)),
    ("Conv2d_2c_3x3", "conv", (192, 3, 1)),
    ("MaxPool_3a_3x3", "pool", (3, 2)),
    ("Mixed_3b", "mixed", (64, (96, 128), (16, 32), 32)),
    ("Mixed_3c", "mixed", (128, (128, 192), (32, 96), 64)),
    ("MaxPool_4a_3x3", "pool", (3, 2)),
    ("Mixed_4b", "mixed", (192, (96, 208), (16, 48), 64)),
    ("Mixed_4c", "mixed", (160, (112, 224), (24, 64), 64)),
    ("Mixed_4d", "mixed", (128, (128, 256), (24, 64), 64)),
    ("Mixed_4e", "mixed", (112, (144, 288), (32, 64), 64)),
    ("Mixed_4f", "mixed", (256, (160, 320), (32, 128), 128)),
    ("MaxPool_5a_2x2", "pool", (2, 2)),
    ("Mixed_5b", "mixed", (256, (160, 320), (32, 128), 128)),
    ("Mixed_5c", "mixed", (384, (192, 384), (48, 128), 128)),
]

DEFAULT_IMAGE_SIZE = 224
FEATURE_DIM = 1024
BN_EPS = 0.001


def _conv_bn_init(generator: torch.Generator, k: int, cin: int,
                  cout: int) -> Params:
    """slim truncated-normal FAN_IN kernel, stored OIHW; BN statistics at
    their initial values."""
    hwio = layers.slim_variance_scaling(generator, (k, k, cin, cout),
                                        k * k * cin)
    return {
        "weights": hwio.permute(3, 2, 0, 1).contiguous(),
        "BatchNorm": {
            "beta": torch.zeros(cout),
            "moving_mean": torch.zeros(cout),
            "moving_variance": torch.ones(cout),
        },
    }


def init_params(generator: torch.Generator) -> Params:
    """The full Inception-V1 parameter tree (no logits head), on the CPU."""
    params: Params = {}
    cin = 3
    for name, kind, spec in _V1_BLOCKS:
        if kind == "conv":
            filters, k, _ = spec
            params[name] = _conv_bn_init(generator, k, cin, filters)
            cin = filters
        elif kind == "mixed":
            b0, (b1a, b1b), (b2a, b2b), b3 = spec
            params[name] = {
                "Branch_0": {
                    "Conv2d_0a_1x1": _conv_bn_init(generator, 1, cin, b0)},
                "Branch_1": {
                    "Conv2d_0a_1x1": _conv_bn_init(generator, 1, cin, b1a),
                    "Conv2d_0b_3x3": _conv_bn_init(generator, 3, b1a, b1b),
                },
                "Branch_2": {
                    "Conv2d_0a_1x1": _conv_bn_init(generator, 1, cin, b2a),
                    "Conv2d_0b_3x3": _conv_bn_init(generator, 3, b2a, b2b),
                },
                "Branch_3": {
                    "Conv2d_0b_1x1": _conv_bn_init(generator, 1, cin, b3)},
            }
            cin = b0 + b1b + b2b + b3
    return params


def _mixed_block(p: Params, x: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inception mixed block; the three input-side 1x1 convs run as one
    merged conv (exact, layers.merged_1x1_bn_relu). Reference: slim
    inception_v1 Mixed blocks (inception_v1.py:96-563)."""
    b0, b1, b2 = layers.merged_1x1_bn_relu(
        [p["Branch_0"]["Conv2d_0a_1x1"], p["Branch_1"]["Conv2d_0a_1x1"],
         p["Branch_2"]["Conv2d_0a_1x1"]], x, BN_EPS, dtype)
    b1 = layers.conv_bn(p["Branch_1"]["Conv2d_0b_3x3"], b1, 1, BN_EPS,
                        dtype)
    b2 = layers.conv_bn(p["Branch_2"]["Conv2d_0b_3x3"], b2, 1, BN_EPS,
                        dtype)
    b3 = layers.max_pool(x, 3, 1)
    b3 = layers.conv_bn(p["Branch_3"]["Conv2d_0b_1x1"], b3, 1, BN_EPS,
                        dtype)
    return torch.cat([b0, b1, b2, b3], dim=1)


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Mixed_5c",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the base network up to ``final_endpoint``.

    Args:
      images: (B, 3, H, W) preprocessed to [-1, 1].
    Returns:
      (net, end_points), float32 NCHW, slim endpoint names.
    """
    end_points: Dict[str, torch.Tensor] = {}
    net = images
    for name, kind, spec in _V1_BLOCKS:
        if kind == "conv":
            _, _, stride = spec
            net = layers.conv_bn(params[name], net, stride, BN_EPS, dtype)
        elif kind == "pool":
            k, stride = spec
            net = layers.max_pool(net, k, stride)
        else:
            net = _mixed_block(params[name], net, dtype)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    raise ValueError(f"Unknown final endpoint {final_endpoint}")


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    """num_classes=None head: global average pool -> (B, 1024) (slim's 7x7
    VALID average pool at 224 input, any input size here)."""
    return net.mean(dim=(2, 3))
