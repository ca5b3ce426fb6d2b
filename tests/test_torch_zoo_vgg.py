"""The port's VGG-16/19 against comic_tpu on the CPU: every endpoint in
float32 at 224x224 (the smallest input whose fc6, a 7x7 VALID conv, fits;
one image), encode_images with the legacy head on and off, the init tree's
structure, the weight bridge's round trip, and the bfloat16 layers, each
fed the same input in both packages (test_torch_encoder.bf16_close)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import vgg as jvgg
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import vgg as tvgg
from test_torch_encoder import (bf16_close, check_encode_images,
                                check_endpoints, check_init_tree,
                                check_round_trip, nchw, zoo_case, zoo_tree)

torch.set_num_threads(1)

NETS = {"vgg_16": (224, 1), "vgg_19": (224, 1)}
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


def _x(shape, seed=3):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, nchw(x)


def test_bf16_layers_vgg():
    """A conv with bias and relu, and fc6 (a 7x7 VALID conv)."""
    tree = zoo_tree("vgg_16")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 16, 16, 3))
    bf16_close(tvgg._conv(params["conv1"]["conv1_1"], timg,
                          dtype=torch.bfloat16),
               jvgg._conv(tree["conv1"]["conv1_1"], img, dtype=BF16),
               "conv1_1")
    x, tx = _x((2, 7, 7, 512))
    bf16_close(tvgg._conv(params["fc6"], tx, "VALID", torch.bfloat16),
               jvgg._conv(tree["fc6"], x, padding="VALID", dtype=BF16),
               "fc6")
