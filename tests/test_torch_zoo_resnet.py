"""The port's ResNet-v1 and v2 (50/101/152) against comic_tpu on the CPU:
every endpoint in float32 at 32x32, encode_images with the legacy head on
and off, the init tree's structure, the weight bridge's round trip, slim's
fixed padding, and each module's bfloat16 layers, each fed the same input
in both packages (test_torch_encoder.bf16_close)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import resnet as jres
from comic_tpu.models import resnet_v2 as jr2
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import resnet as tres
from comic_tpu_torch.models import resnet_v2 as tr2
from test_torch_encoder import (bf16_close, check_encode_images,
                                check_endpoints, check_init_tree,
                                check_round_trip, nchw, zoo_case, zoo_tree)

torch.set_num_threads(1)

NETS = {name: (32, 2) for name in ("resnet_v1_50", "resnet_v1_101",
                                   "resnet_v1_152", "resnet_v2_50",
                                   "resnet_v2_101", "resnet_v2_152")}
BF16 = jnp.bfloat16


@pytest.fixture(scope="module", params=list(NETS))
def case(request):
    return zoo_case(request.param, *NETS[request.param])


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


def test_slim_padding_is_not_tf_same():
    """slim's conv2d_same pads a 7x7/2 conv 3 and 3 where TF's SAME rule
    pads 2 and 3 on an even input: the port keeps them apart."""
    assert tres.slim_padding(7, 2) == ((3, 3), (3, 3))
    assert tres.slim_padding(3, 1) == "SAME"
    x = torch.randn(1, 2, 8, 8)
    w = torch.randn(4, 2, 7, 7)
    got = tres.strided_conv(x, w, 2)
    want = torch.nn.functional.conv2d(x, w, stride=2, padding=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _x(shape, seed=3):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, nchw(x)


def test_bf16_layers_resnet_v1():
    """The 7x7/2 root conv (slim's fixed pad) and a strided bottleneck with
    a projection shortcut."""
    tree = zoo_tree("resnet_v1_50")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 18, 18, 3))
    bf16_close(tres._conv_bn(params["conv1"], timg, 2, torch.bfloat16),
               jres._conv_bn(tree["conv1"], img, 2, BF16), "conv1")
    for unit, cin in (("unit_1", 64), ("unit_3", 256)):
        x, tx = _x((2, 9, 9, cin))
        bf16_close(tres._bottleneck(
            params["block1"][unit]["bottleneck_v1"], tx, 2, torch.bfloat16),
            jres._bottleneck(tree["block1"][unit]["bottleneck_v1"], x, 2,
                             BF16), f"block1/{unit}")


def test_bf16_layers_resnet_v2():
    """The root conv with a bias, and pre-activation bottlenecks (with a
    projection shortcut from the preactivation, and strided)."""
    tree = zoo_tree("resnet_v2_50")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 18, 18, 3))
    bf16_close(tr2._conv(params["conv1"], timg, 2, torch.bfloat16),
               jr2._conv(tree["conv1"]["weights"], img, 2, BF16,
                         tree["conv1"]["biases"]), "conv1")
    for unit, cin, stride in (("unit_1", 64, 1), ("unit_3", 256, 2)):
        x, tx = _x((2, 9, 9, cin))
        bf16_close(tr2._bottleneck_v2(
            params["block1"][unit]["bottleneck_v2"], tx, stride,
            torch.bfloat16),
            jr2._bottleneck_v2(tree["block1"][unit]["bottleneck_v2"], x,
                               stride, BF16), f"block1/{unit}")
