"""The port's Inception-V2, V3, V4 and Inception-ResNet-V2 against
comic_tpu on the CPU: every endpoint in float32 at a small input (the
smallest the VALID stems of V3, V4 and Inception-ResNet-V2 accept, 75;
32 for V2), encode_images with the legacy head on and off, the init tree's
structure, the weight bridge's round trip, and for each module its
bfloat16 layers, each fed the same input in both packages
(test_torch_encoder.bf16_close)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import inception_resnet_v2 as jirv2
from comic_tpu.models import inception_v2 as jiv2
from comic_tpu.models import inception_v3 as jiv3
from comic_tpu.models import inception_v4 as jiv4
from comic_tpu.models import layers as jlayers
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import inception_resnet_v2 as tirv2
from comic_tpu_torch.models import inception_v2 as tiv2
from comic_tpu_torch.models import inception_v3 as tiv3
from comic_tpu_torch.models import inception_v4 as tiv4
from comic_tpu_torch.models import layers as tlayers
from test_torch_encoder import (bf16_close, check_encode_images,
                                check_endpoints, check_init_tree,
                                check_round_trip, nchw, zoo_case, zoo_tree)

torch.set_num_threads(1)

NETS = {"inception_v2": 32, "inception_v3": 75, "inception_v4": 75,
        "inception_resnet_v2": 75}
BF16 = jnp.bfloat16


@pytest.fixture(scope="module", params=list(NETS))
def case(request):
    return zoo_case(request.param, NETS[request.param])


def test_endpoints_match(case):
    check_endpoints(case)


@pytest.mark.parametrize("legacy", [False, True])
def test_encode_images_match(case, legacy):
    check_encode_images(case, legacy)


@pytest.mark.parametrize("name", list(NETS))
def test_init_tree_matches_comic_tpu(name):
    check_init_tree(name)


def test_bridge_round_trip(case):
    check_round_trip(case)


def _x(shape, seed=3):
    """A seeded NHWC float32 input and its NCHW twin."""
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, nchw(x)


def test_bf16_layers_inception_v2():
    """The separable stem (depthwise, its float32 output rounded again for
    the pointwise conv), a strided 3x3, and the merged input-side 1x1s."""
    tree = zoo_tree("inception_v2")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 17, 17, 3))
    _, want = jiv2.apply(tree, img, final_endpoint="Mixed_3b", dtype=BF16)
    _, got = tiv2.apply(params, timg, final_endpoint="Mixed_3b",
                        dtype=torch.bfloat16)
    bf16_close(got["Conv2d_1a_7x7"], want["Conv2d_1a_7x7"], "stem")
    x, tx = _x((2, 9, 9, 64))
    bf16_close(tiv2._conv(params["Conv2d_2c_3x3"], tx, 2, torch.bfloat16),
               jiv2._conv_bn_relu(tree["Conv2d_2c_3x3"], x, 2, BF16),
               "Conv2d_2c_3x3")
    x, tx = _x((2, 5, 5, 192))
    block = "Branch_0", "Branch_1", "Branch_2"
    for g, w in zip(
            tlayers.merged_1x1_bn_relu(
                [params["Mixed_3b"][b]["Conv2d_0a_1x1"] for b in block], tx,
                tiv2.BN_EPS, torch.bfloat16),
            jlayers.merged_1x1_bn_relu(
                [tree["Mixed_3b"][b]["Conv2d_0a_1x1"] for b in block], x,
                jiv2.BN_EPS, BF16)):
        bf16_close(g, w, "merged 1x1")


def test_bf16_layers_inception_v3():
    """A VALID strided stem conv and a factorized 1x7 conv."""
    tree = zoo_tree("inception_v3")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 17, 17, 3))
    bf16_close(tiv3.conv_bn_relu(params["Conv2d_1a_3x3"], timg, 2, "VALID",
                                 torch.bfloat16),
               jiv3._conv(tree["Conv2d_1a_3x3"], img, (3, 3), 2, "VALID",
                          BF16), "Conv2d_1a_3x3")
    p = ("Mixed_6b", "Branch_1", "Conv2d_0b_1x7")
    x, tx = _x((2, 9, 9, 128))
    bf16_close(tiv3.conv_bn_relu(params[p[0]][p[1]][p[2]], tx, 1, "SAME",
                                 torch.bfloat16),
               jiv3._conv(tree[p[0]][p[1]][p[2]], x, (1, 7), 1, "SAME",
                          BF16), "/".join(p))


def test_bf16_layers_inception_v4():
    """The stem's first conv, through apply, and a reduction-A block."""
    tree = zoo_tree("inception_v4")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 17, 17, 3))
    _, want = jiv4.apply(tree, img, final_endpoint="Conv2d_1a_3x3",
                         dtype=BF16)
    _, got = tiv4.apply(params, timg, final_endpoint="Conv2d_1a_3x3",
                        dtype=torch.bfloat16)
    bf16_close(got["Conv2d_1a_3x3"], want["Conv2d_1a_3x3"], "stem")
    x, tx = _x((2, 7, 7, 384))
    bf16_close(tiv3.apply_mixed_block(params["Mixed_6a"], tiv4._REDUCTION_A,
                                      tx, torch.bfloat16),
               jiv3.apply_mixed_block(tree["Mixed_6a"], jiv4._REDUCTION_A,
                                      x, BF16), "Mixed_6a")


def test_bf16_layers_inception_resnet_v2():
    """A VALID strided stem conv, the residual up-projection (a linear
    conv with bias) and a whole block35 (scaled residual and relu)."""
    tree = zoo_tree("inception_resnet_v2")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 17, 17, 3))
    bf16_close(tirv2._conv(params["Conv2d_1a_3x3"], timg, 2, "VALID",
                           torch.bfloat16),
               jirv2._conv_bn_relu(tree["Conv2d_1a_3x3"], img, 2, "VALID",
                                   BF16), "Conv2d_1a_3x3")
    blk_t = params["Repeat"]["block35_1"]
    blk_j = tree["Repeat"]["block35_1"]
    x, tx = _x((2, 5, 5, 128))
    bf16_close(tirv2._conv_linear(blk_t["Conv2d_1x1"], tx, torch.bfloat16),
               jirv2._conv_linear(blk_j["Conv2d_1x1"], x, BF16),
               "block35 up-projection")
    x, tx = _x((2, 5, 5, 320))
    bf16_close(tirv2._res_block_apply(blk_t, tirv2._BLOCK35, tx, 0.17,
                                      torch.bfloat16),
               jirv2._res_block_apply(blk_j, jirv2._BLOCK35, x, 0.17, BF16),
               "block35")
