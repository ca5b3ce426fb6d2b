"""Inception-V3 image encoder, counterpart of
comic_tpu/models/inception_v3.py (slim inception_v3).

The network is a data table: a stem with VALID paddings, then inception
blocks whose branches are lists of primitive ops. Param keys are slim's
scope names, the Mixed_5c quirks ('Conv2d_0b_1x1', 'Conv_1_0c_5x5')
included. BN scale=False, eps 0.001, inference mode always. The pooled
feature is the global average of Mixed_7c (B, 2048). Default input
299x299 (the pipeline crops the 256x256 host image, so 224 is what a user
runs), inception preprocessing. Feature maps are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers
from .inception_v1 import BN_EPS

Params = Dict[str, Any]

DEFAULT_IMAGE_SIZE = 299
FEATURE_DIM = 2048

# stem: (name, kind, spec)
#   conv: (cout, (kh, kw), stride, padding)
#   maxpool: (k, stride), VALID
_STEM = [
    ("Conv2d_1a_3x3", "conv", (32, (3, 3), 2, "VALID")),
    ("Conv2d_2a_3x3", "conv", (32, (3, 3), 1, "VALID")),
    ("Conv2d_2b_3x3", "conv", (64, (3, 3), 1, "SAME")),
    ("MaxPool_3a_3x3", "maxpool", (3, 2)),
    ("Conv2d_3b_1x1", "conv", (80, (1, 1), 1, "VALID")),
    ("Conv2d_4a_3x3", "conv", (192, (3, 3), 1, "VALID")),
    ("MaxPool_5a_3x3", "maxpool", (3, 2)),
]


# branch op: ("conv", scope, cout, (kh, kw), stride, padding)
#            ("maxpool"/"avgpool", scope, k, stride, padding)
#            ("fanout", [conv ops])  -- parallel convs on the same input,
#                                       concatenated (Mixed_7b/7c)
def _std_17(inner: int) -> list:
    return [
        [("conv", "Conv2d_0a_1x1", 192, (1, 1), 1, "SAME")],
        [("conv", "Conv2d_0a_1x1", inner, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_1x7", inner, (1, 7), 1, "SAME"),
         ("conv", "Conv2d_0c_7x1", 192, (7, 1), 1, "SAME")],
        [("conv", "Conv2d_0a_1x1", inner, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_7x1", inner, (7, 1), 1, "SAME"),
         ("conv", "Conv2d_0c_1x7", inner, (1, 7), 1, "SAME"),
         ("conv", "Conv2d_0d_7x1", inner, (7, 1), 1, "SAME"),
         ("conv", "Conv2d_0e_1x7", 192, (1, 7), 1, "SAME")],
        [("avgpool", "AvgPool_0a_3x3", 3, 1, "SAME"),
         ("conv", "Conv2d_0b_1x1", 192, (1, 1), 1, "SAME")],
    ]


def _expand_8(first: str) -> list:
    return [
        [("conv", "Conv2d_0a_1x1", 320, (1, 1), 1, "SAME")],
        [("conv", "Conv2d_0a_1x1", 384, (1, 1), 1, "SAME"),
         ("fanout", [("conv", "Conv2d_0b_1x3", 384, (1, 3), 1, "SAME"),
                     ("conv", first, 384, (3, 1), 1, "SAME")])],
        [("conv", "Conv2d_0a_1x1", 448, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_3x3", 384, (3, 3), 1, "SAME"),
         ("fanout", [("conv", "Conv2d_0c_1x3", 384, (1, 3), 1, "SAME"),
                     ("conv", "Conv2d_0d_3x1", 384, (3, 1), 1, "SAME")])],
        [("avgpool", "AvgPool_0a_3x3", 3, 1, "SAME"),
         ("conv", "Conv2d_0b_1x1", 192, (1, 1), 1, "SAME")],
    ]


def _mixed_5(first_b1: str, second_b1: str, pool_out: int) -> list:
    return [
        [("conv", "Conv2d_0a_1x1", 64, (1, 1), 1, "SAME")],
        [("conv", first_b1, 48, (1, 1), 1, "SAME"),
         ("conv", second_b1, 64, (5, 5), 1, "SAME")],
        [("conv", "Conv2d_0a_1x1", 64, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_3x3", 96, (3, 3), 1, "SAME"),
         ("conv", "Conv2d_0c_3x3", 96, (3, 3), 1, "SAME")],
        [("avgpool", "AvgPool_0a_3x3", 3, 1, "SAME"),
         ("conv", "Conv2d_0b_1x1", pool_out, (1, 1), 1, "SAME")],
    ]


_MIXED: List[Tuple[str, list]] = [
    ("Mixed_5b", _mixed_5("Conv2d_0a_1x1", "Conv2d_0b_5x5", 32)),
    # slim's historical scope quirks, kept for checkpoint parity
    ("Mixed_5c", _mixed_5("Conv2d_0b_1x1", "Conv_1_0c_5x5", 64)),
    ("Mixed_5d", _mixed_5("Conv2d_0a_1x1", "Conv2d_0b_5x5", 64)),
    ("Mixed_6a", [
        [("conv", "Conv2d_1a_1x1", 384, (3, 3), 2, "VALID")],
        [("conv", "Conv2d_0a_1x1", 64, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_3x3", 96, (3, 3), 1, "SAME"),
         ("conv", "Conv2d_1a_1x1", 96, (3, 3), 2, "VALID")],
        [("maxpool", "MaxPool_1a_3x3", 3, 2, "VALID")],
    ]),
    ("Mixed_6b", _std_17(128)),
    ("Mixed_6c", _std_17(160)),
    ("Mixed_6d", _std_17(160)),
    ("Mixed_6e", _std_17(192)),
    ("Mixed_7a", [
        [("conv", "Conv2d_0a_1x1", 192, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_1a_3x3", 320, (3, 3), 2, "VALID")],
        [("conv", "Conv2d_0a_1x1", 192, (1, 1), 1, "SAME"),
         ("conv", "Conv2d_0b_1x7", 192, (1, 7), 1, "SAME"),
         ("conv", "Conv2d_0c_7x1", 192, (7, 1), 1, "SAME"),
         ("conv", "Conv2d_1a_3x3", 192, (3, 3), 2, "VALID")],
        [("maxpool", "MaxPool_1a_3x3", 3, 2, "VALID")],
    ]),
    ("Mixed_7b", _expand_8("Conv2d_0b_3x1")),
    ("Mixed_7c", _expand_8("Conv2d_0c_3x1")),
]


def conv_bn_relu(p: Params, x: torch.Tensor, stride: int, padding,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return layers.conv_bn(p, x, stride, BN_EPS, dtype, padding)


def _pool(x, k, stride, padding, kind):
    if kind == "maxpool":
        return layers.max_pool(x, k, stride, padding)
    return layers.avg_pool(x, k, stride, padding)


def init_block(generator: torch.Generator, branches, cin: int
               ) -> Tuple[Params, int]:
    """One table-driven mixed block's params -> (params, output channels:
    the branches' outputs, a pool-only branch passing cin through)."""
    block: Params = {}
    total = 0
    for bi, ops in enumerate(branches):
        bp: Params = {}
        c = cin
        for op in ops:
            convs = op[1] if op[0] == "fanout" else [op] if op[0] == "conv" \
                else []
            for _, scope, cout, (kh, kw), _, _ in convs:
                bp[scope] = layers.conv_bn_init(generator, kh, kw, c, cout)
            if convs:
                c = sum(sub[2] for sub in convs)
        block[f"Branch_{bi}"] = bp
        total += c
    return block, total


def init_params(generator: torch.Generator) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    params: Params = {}
    cin = 3
    for name, kind, spec in _STEM:
        if kind == "conv":
            cout, (kh, kw), _, _ = spec
            params[name] = layers.conv_bn_init(generator, kh, kw, cin, cout)
            cin = cout
    for name, branches in _MIXED:
        params[name], cin = init_block(generator, branches, cin)
    return params


def _apply_branch_ops(bp, y, ops, dtype):
    for op in ops:
        if op[0] == "conv":
            _, scope, _, _, stride, padding = op
            y = conv_bn_relu(bp[scope], y, stride, padding, dtype)
        elif op[0] == "fanout":
            y = torch.cat([conv_bn_relu(bp[s[1]], y, s[4], s[5], dtype)
                           for s in op[1]], dim=1)
        else:
            kind, _, k, stride, padding = op
            y = _pool(y, k, stride, padding, kind)
    return y


def apply_mixed_block(block_params: Params, branches, net: torch.Tensor,
                      dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One table-driven inception mixed block, shared by inception v3 and
    v4 (slim inception_v3.py:108-494, inception_v4.py:47-225). Each branch
    runs on its own: comic_tpu's merged-1x1 option is off for v3 and v4."""
    return torch.cat([_apply_branch_ops(block_params[f"Branch_{bi}"], net,
                                        ops, dtype)
                      for bi, ops in enumerate(branches)], dim=1)


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Mixed_7c",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW."""
    end_points: Dict[str, torch.Tensor] = {}
    net = images
    for name, kind, spec in _STEM:
        if kind == "conv":
            _, _, stride, padding = spec
            net = conv_bn_relu(params[name], net, stride, padding, dtype)
        else:
            k, stride = spec
            net = layers.max_pool(net, k, stride, "VALID")
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    for name, branches in _MIXED:
        net = apply_mixed_block(params[name], branches, net, dtype)
        end_points[name] = net
        if name == final_endpoint:
            return net, end_points
    return net, end_points


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    return net.mean(dim=(2, 3))
