"""Inception-ResNet-V2 image encoder, counterpart of
comic_tpu/models/inception_resnet_v2.py (slim inception_resnet_v2.py:
33-307, output_stride 16, align_feature_maps False).

  - the stem's strided and 3x3 convs and its pools are VALID; everything
    else is SAME;
  - a residual block: branches (conv + BN + relu) -> concat -> 1x1 linear
    conv WITH bias and no BN -> scaled -> added to the input -> relu; the
    final Block8 has no activation;
  - the three residual stacks are Repeat/block35_i (x10, scale 0.17),
    Repeat_1/block17_i (x20, scale 0.10; its output is PreAuxLogits) and
    Repeat_2/block8_i (x9, scale 0.20);
  - BN scale=False, eps 0.001, inference mode always;
  - the pooled feature is the global average of Conv2d_7b_1x1 (B, 1536).

Param keys are slim's. Inception preprocessing, default input 299. NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers

Params = Dict[str, Any]

BN_EPS = 0.001
DEFAULT_IMAGE_SIZE = 299
FEATURE_DIM = 1536

# residual block tables: (branch name, [(conv name, kh, kw, cout), ...])
# (inception_resnet_v2.py:33-107)
_BLOCK35 = [
    ("Branch_0", [("Conv2d_1x1", 1, 1, 32)]),
    ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 32), ("Conv2d_0b_3x3", 3, 3, 32)]),
    ("Branch_2", [("Conv2d_0a_1x1", 1, 1, 32), ("Conv2d_0b_3x3", 3, 3, 48),
                  ("Conv2d_0c_3x3", 3, 3, 64)]),
]
_BLOCK17 = [
    ("Branch_0", [("Conv2d_1x1", 1, 1, 192)]),
    ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 128), ("Conv2d_0b_1x7", 1, 7, 160),
                  ("Conv2d_0c_7x1", 7, 1, 192)]),
]
_BLOCK8 = [
    ("Branch_0", [("Conv2d_1x1", 1, 1, 192)]),
    ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 192), ("Conv2d_0b_1x3", 1, 3, 224),
                  ("Conv2d_0c_3x1", 3, 1, 256)]),
]

# (scope, block table, block name, input channels, repeats, residual scale)
_REPEATS = [
    ("Repeat", _BLOCK35, "block35", 320, 10, 0.17),
    ("Repeat_1", _BLOCK17, "block17", 1088, 20, 0.10),
    ("Repeat_2", _BLOCK8, "block8", 2080, 9, 0.20),
]

# stem convs: (name, kh, kw, cin, cout)
_STEM = [("Conv2d_1a_3x3", 3, 3, 3, 32), ("Conv2d_2a_3x3", 3, 3, 32, 32),
         ("Conv2d_2b_3x3", 3, 3, 32, 64), ("Conv2d_3b_1x1", 1, 1, 64, 80),
         ("Conv2d_4a_3x3", 3, 3, 80, 192)]


def _branches_init(g: torch.Generator, spec) -> Params:
    """{branch: {conv: params}} from (branch, [(conv, kh, kw, cin, cout)])."""
    return {b: {c: layers.conv_bn_init(g, kh, kw, cin, cout)
                for c, kh, kw, cin, cout in convs} for b, convs in spec}


def _res_block_init(g: torch.Generator, table, cin: int) -> Params:
    p: Params = {}
    concat = 0
    for bname, convs in table:
        branch: Params = {}
        c = cin
        for cname, kh, kw, cout in convs:
            branch[cname] = layers.conv_bn_init(g, kh, kw, c, cout)
            c = cout
        concat += c
        p[bname] = branch
    # the residual up-projection: linear 1x1 conv with bias, no BN
    p["Conv2d_1x1"] = {"weights": layers.conv_kernel(g, 1, 1, concat, cin),
                       "biases": torch.zeros(cin)}
    return p


def init_params(generator: torch.Generator) -> Params:
    """The full parameter tree (no logits head), on the CPU."""
    g = generator
    params: Params = {name: layers.conv_bn_init(g, kh, kw, cin, cout)
                      for name, kh, kw, cin, cout in _STEM}
    # Mixed_5b (:190-210): 96 + 64 + 96 + 64 = 320
    params["Mixed_5b"] = _branches_init(g, [
        ("Branch_0", [("Conv2d_1x1", 1, 1, 192, 96)]),
        ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 192, 48),
                      ("Conv2d_0b_5x5", 5, 5, 48, 64)]),
        ("Branch_2", [("Conv2d_0a_1x1", 1, 1, 192, 64),
                      ("Conv2d_0b_3x3", 3, 3, 64, 96),
                      ("Conv2d_0c_3x3", 3, 3, 96, 96)]),
        ("Branch_3", [("Conv2d_0b_1x1", 1, 1, 192, 64)])])
    for rname, table, bname, cin, n, _ in _REPEATS:
        params[rname] = {f"{bname}_{i}": _res_block_init(g, table, cin)
                         for i in range(1, n + 1)}
        if rname == "Repeat":
            # Mixed_6a (:220-237): 384 + 384 + 320 (pool) = 1088
            params["Mixed_6a"] = _branches_init(g, [
                ("Branch_0", [("Conv2d_1a_3x3", 3, 3, 320, 384)]),
                ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 320, 256),
                              ("Conv2d_0b_3x3", 3, 3, 256, 256),
                              ("Conv2d_1a_3x3", 3, 3, 256, 384)]),
                ("Branch_2", [])])  # max pool, no params
        elif rname == "Repeat_1":
            # Mixed_7a (:253-276): 384 + 288 + 320 + 1088 (pool) = 2080
            params["Mixed_7a"] = _branches_init(g, [
                ("Branch_0", [("Conv2d_0a_1x1", 1, 1, 1088, 256),
                              ("Conv2d_1a_3x3", 3, 3, 256, 384)]),
                ("Branch_1", [("Conv2d_0a_1x1", 1, 1, 1088, 256),
                              ("Conv2d_1a_3x3", 3, 3, 256, 288)]),
                ("Branch_2", [("Conv2d_0a_1x1", 1, 1, 1088, 256),
                              ("Conv2d_0b_3x3", 3, 3, 256, 288),
                              ("Conv2d_1a_3x3", 3, 3, 288, 320)]),
                ("Branch_3", [])])  # max pool, no params
    # the final Block8 (no activation) and Conv2d_7b_1x1 (:281-286)
    params["Block8"] = _res_block_init(g, _BLOCK8, 2080)
    params["Conv2d_7b_1x1"] = layers.conv_bn_init(g, 1, 1, 2080, 1536)
    return params


def _conv(p, x, stride=1, padding="SAME", dtype=None):
    return layers.conv_bn(p, x, stride, BN_EPS, dtype, padding)


def _conv_linear(p, x, dtype=None):
    """The residual up-projection: a 1x1 conv with bias, no BN."""
    return (layers.conv_f32(x, p["weights"], 1, "SAME", dtype)
            + p["biases"].view(1, -1, 1, 1))


def _res_block_apply(p, table, x, scale, dtype=None, relu=True):
    # every branch starts with a 1x1 conv over x: one merged conv, as in
    # comic_tpu (layers.merged_1x1_bn_relu)
    firsts = layers.merged_1x1_bn_relu(
        [p[bname][convs[0][0]] for bname, convs in table], x, BN_EPS, dtype)
    branches = []
    for (bname, convs), y in zip(table, firsts):
        for cname, _, _, _ in convs[1:]:
            y = _conv(p[bname][cname], y, dtype=dtype)
        branches.append(y)
    mixed = torch.cat(branches, dim=1)
    y = x + scale * _conv_linear(p["Conv2d_1x1"], mixed, dtype)
    return torch.relu(y) if relu else y


def apply(params: Params, images: torch.Tensor,
          final_endpoint: str = "Conv2d_7b_1x1",
          dtype: Optional[torch.dtype] = None,
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, 3, H, W) in [-1, 1] -> (net, end_points), float32 NCHW, up to
    ``final_endpoint`` (inception_resnet_v2.py:111-290)."""
    ep: Dict[str, torch.Tensor] = {}

    def done(name, net):
        ep[name] = net
        return name == final_endpoint

    net = images
    for name, stride, padding in (("Conv2d_1a_3x3", 2, "VALID"),
                                  ("Conv2d_2a_3x3", 1, "VALID"),
                                  ("Conv2d_2b_3x3", 1, "SAME"),
                                  ("MaxPool_3a_3x3", 2, "VALID"),
                                  ("Conv2d_3b_1x1", 1, "VALID"),
                                  ("Conv2d_4a_3x3", 1, "VALID"),
                                  ("MaxPool_5a_3x3", 2, "VALID")):
        if name.startswith("MaxPool"):
            net = layers.max_pool(net, 3, stride, padding)
        else:
            net = _conv(params[name], net, stride, padding, dtype)
        if done(name, net):
            return net, ep

    # Mixed_5b (the input-side 1x1s merged)
    p = params["Mixed_5b"]
    b0, b1, b2 = layers.merged_1x1_bn_relu(
        [p["Branch_0"]["Conv2d_1x1"], p["Branch_1"]["Conv2d_0a_1x1"],
         p["Branch_2"]["Conv2d_0a_1x1"]], net, BN_EPS, dtype)
    b1 = _conv(p["Branch_1"]["Conv2d_0b_5x5"], b1, dtype=dtype)
    b2 = _conv(p["Branch_2"]["Conv2d_0b_3x3"], b2, dtype=dtype)
    b2 = _conv(p["Branch_2"]["Conv2d_0c_3x3"], b2, dtype=dtype)
    b3 = _conv(p["Branch_3"]["Conv2d_0b_1x1"], layers.avg_pool(net, 3),
               dtype=dtype)
    net = torch.cat([b0, b1, b2, b3], dim=1)
    if done("Mixed_5b", net):
        return net, ep

    for i in range(1, 11):
        net = _res_block_apply(params["Repeat"][f"block35_{i}"], _BLOCK35,
                               net, 0.17, dtype)

    p = params["Mixed_6a"]
    b0 = _conv(p["Branch_0"]["Conv2d_1a_3x3"], net, 2, "VALID", dtype)
    b1 = _conv(p["Branch_1"]["Conv2d_0a_1x1"], net, dtype=dtype)
    b1 = _conv(p["Branch_1"]["Conv2d_0b_3x3"], b1, dtype=dtype)
    b1 = _conv(p["Branch_1"]["Conv2d_1a_3x3"], b1, 2, "VALID", dtype)
    b2 = layers.max_pool(net, 3, 2, "VALID")
    net = torch.cat([b0, b1, b2], dim=1)
    if done("Mixed_6a", net):
        return net, ep

    for i in range(1, 21):
        net = _res_block_apply(params["Repeat_1"][f"block17_{i}"], _BLOCK17,
                               net, 0.10, dtype)
    if done("PreAuxLogits", net):
        return net, ep

    # Mixed_7a (the input-side 1x1s merged)
    p = params["Mixed_7a"]
    b0, b1, b2 = layers.merged_1x1_bn_relu(
        [p["Branch_0"]["Conv2d_0a_1x1"], p["Branch_1"]["Conv2d_0a_1x1"],
         p["Branch_2"]["Conv2d_0a_1x1"]], net, BN_EPS, dtype)
    b0 = _conv(p["Branch_0"]["Conv2d_1a_3x3"], b0, 2, "VALID", dtype)
    b1 = _conv(p["Branch_1"]["Conv2d_1a_3x3"], b1, 2, "VALID", dtype)
    b2 = _conv(p["Branch_2"]["Conv2d_0b_3x3"], b2, dtype=dtype)
    b2 = _conv(p["Branch_2"]["Conv2d_1a_3x3"], b2, 2, "VALID", dtype)
    b3 = layers.max_pool(net, 3, 2, "VALID")
    net = torch.cat([b0, b1, b2, b3], dim=1)
    if done("Mixed_7a", net):
        return net, ep

    for i in range(1, 10):
        net = _res_block_apply(params["Repeat_2"][f"block8_{i}"], _BLOCK8,
                               net, 0.20, dtype)
    net = _res_block_apply(params["Block8"], _BLOCK8, net, 1.0, dtype,
                           relu=False)
    net = _conv(params["Conv2d_7b_1x1"], net, dtype=dtype)
    if done("Conv2d_7b_1x1", net):
        return net, ep
    raise ValueError(f"Unknown final endpoint {final_endpoint}")


def pooled_features(net: torch.Tensor) -> torch.Tensor:
    """The global average pool -> (B, 1536)."""
    return net.mean(dim=(2, 3))
