"""The port's PNASNet-5 (mobile and large) against comic_tpu on the CPU,
with the checks of tests/test_torch_zoo_nasnet.py: every endpoint in
float32 at 32x32, encode_images with the legacy head on and off, the init
tree leaf for leaf, the weight bridge's round trip, and bfloat16
separable convs, a factorized reduction and a whole stem cell (PNASNet's
normal cell), each fed the same input in both packages."""

import pytest
import torch

from test_torch_encoder import (check_encode_images, check_endpoints,
                                check_init_tree, check_round_trip, zoo_case)
from test_torch_zoo_nasnet import check_bf16_layers

torch.set_num_threads(1)

NETS = {"pnasnet_mobile": 32, "pnasnet_large": 32}


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


def test_bf16_layers_pnasnet():
    check_bf16_layers("pnasnet_mobile")
