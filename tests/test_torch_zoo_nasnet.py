"""The port's NASNet-A (mobile and large) against comic_tpu on the CPU
(PNASNet-5 in tests/test_torch_zoo_pnasnet.py, with these checks): every
endpoint in float32 at 32x32, encode_images with the
legacy head on and off, the init tree (collected by a forward on the meta
device) against comic_tpu's leaf for leaf, compound leaf keys included,
the weight bridge's round trip, a compact checkpoint read both ways, and
bfloat16 separable convs, factorized reductions and whole stem cells,
each fed the same input in both packages
(test_torch_encoder.bf16_close)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import nasnet as jnn
from comic_tpu.training import checkpoints as jckpt
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import nasnet as tnn
from comic_tpu_torch.training import checkpoints as tckpt
from test_torch_encoder import (bf16_close, check_encode_images,
                                check_endpoints, check_init_tree,
                                check_round_trip, nchw, zoo_case, zoo_tree)

torch.set_num_threads(1)

NETS = {"nasnet_mobile": 32, "nasnet_large": 32}
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
    left = case[1]["cell_stem_0"]["comb_iter_0"]["left"]
    assert "separable_5x5_1/depthwise_weights" in left  # a compound key


def test_compact_checkpoint_cross_loads(tmp_path):
    """A NASNet-mobile tree (compound keys, depthwise and pointwise
    kernels) saved by comic_tpu loads in the port, and the port's save
    loads in comic_tpu."""
    tree = jax.tree_util.tree_map(np.asarray, zoo_tree("nasnet_mobile"))
    init = tnn.init_params(torch.Generator().manual_seed(0))
    _, jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 1, tree)
    got = bridge.to_jax_tree(tckpt.load_compact(jpath, init))
    tpath = tckpt.save_compact(str(tmp_path / "t"), 1,
                               bridge.from_jax_tree(tree, "cpu"))
    back = jax.tree_util.tree_map(np.asarray,
                                  jckpt.load_compact(tpath, tree))
    for loaded in (got, back):
        assert (jax.tree_util.tree_structure(loaded)
                == jax.tree_util.tree_structure(tree))
        for g, w in zip(jax.tree_util.tree_leaves(loaded),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(g, w)


def _x(shape, seed=3):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, nchw(x)


def _in_scope(store, path, fn):
    """fn(store) under the scopes ``path``."""
    if not path:
        return fn(store)
    with store.scope(path[0]):
        return _in_scope(store, path[1:], fn)


def test_bf16_layers_nasnet():
    check_bf16_layers("nasnet_mobile")


def check_bf16_layers(name):
    """A separable conv (depthwise, then pointwise on its float32 output
    rounded again), the factorized reduction of cell_stem_1's previous
    layer, and the whole of cell_stem_0 on the stem conv's output."""
    tree = zoo_tree(name)
    params = bridge.from_jax_tree(tree, "cpu")
    jstore, tstore = jnn._Store(tree), tnn._Store(params)
    cfg = jnn.CONFIGS[name]
    f0 = int(cfg.num_conv_filters / cfg.filter_scaling_rate ** 2)
    f1 = int(cfg.num_conv_filters / cfg.filter_scaling_rate)
    stem_cell = jnn.PNAS_NORMAL_CELL if cfg.is_pnasnet else \
        jnn.REDUCTION_CELL
    c0 = int(32 * cfg.stem_multiplier)

    sep = ("cell_stem_0", "comb_iter_0", "left")
    cin = tree[sep[0]][sep[1]][sep[2]][
        "separable_5x5_1/depthwise_weights"].shape[2]
    x, tx = _x((2, 9, 9, cin))
    bf16_close(_in_scope(tstore, sep, lambda s: tnn._sep_conv(
        s, "separable_5x5_1", tx, f0, 5, 2, torch.bfloat16)),
        _in_scope(jstore, sep, lambda s: jnn._sep_conv(
            s, "separable_5x5_1", x, f0, 5, 2, BF16)), "separable_5x5_1")

    x, tx = _x((2, 10, 10, c0))
    bf16_close(_in_scope(tstore, ("cell_stem_1",),
                         lambda s: tnn._factorized_reduction(
                             s, tx, f1, 2, torch.bfloat16)),
               _in_scope(jstore, ("cell_stem_1",),
                         lambda s: jnn._factorized_reduction(
                             s, x, f1, 2, BF16)), "factorized reduction")

    x, tx = _x((2, 9, 9, c0))
    bf16_close(tnn._cell(tstore, "cell_stem_0", stem_cell, tx, None, f0, 2,
                         torch.bfloat16),
               jnn._cell(jstore, "cell_stem_0", stem_cell, x, None, f0, 2,
                         BF16), "cell_stem_0")
