"""The port's MobileNet-V1, V2 and V2-1.4 against comic_tpu on the CPU:
every endpoint in float32 at 32x32, encode_images with the legacy head on
and off, the init tree's structure, the weight bridge's round trip
(depthwise kernels (k, k, cin, 1) <-> (cin, 1, k, k)), compact msgpack and
Orbax checkpoints of a MobileNet-V1 captioner read and written both ways,
and each module's bfloat16 layers, each fed the same input in both
packages (test_torch_encoder.bf16_close)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import mobilenet_v1 as jmb1
from comic_tpu.models import mobilenet_v2 as jmb2
from comic_tpu.training import checkpoints as jckpt
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.models import layers as tlayers
from comic_tpu_torch.models import mobilenet_v1 as tmb1
from comic_tpu_torch.models import mobilenet_v2 as tmb2
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from test_torch_encoder import (bf16_close, check_encode_images,
                                check_endpoints, check_init_tree,
                                check_round_trip, nchw, zoo_case, zoo_tree)

torch.set_num_threads(1)

NETS = {"mobilenet_v1": 32, "mobilenet_v2": 32, "mobilenet_v2_140": 32}
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


def test_depthwise_layout():
    """slim's (k, k, cin, mult) depthwise kernel is (cin, mult, k, k) in the
    port; the grouped conv's (cin * mult, 1, k, k) kernel is a view of it
    whose output c * mult + m reads input channel c."""
    dw = np.random.default_rng(0).normal(size=(7, 7, 3, 8)).astype(
        np.float32)
    got = bridge.from_jax_tree({"depthwise_weights": dw}, "cpu")[
        "depthwise_weights"]
    assert tuple(got.shape) == (3, 8, 7, 7)
    grouped = tlayers.depthwise_kernel(got)
    assert tuple(grouped.shape) == (24, 1, 7, 7)
    np.testing.assert_array_equal(grouped[2 * 8 + 5, 0].numpy(),
                                  dw[:, :, 2, 5])
    assert grouped.data_ptr() == got.data_ptr()
    np.testing.assert_array_equal(bridge.to_jax_tree(
        {"depthwise_weights": got})["depthwise_weights"], dw)


WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}
SMALL = dict(cnn_name="mobilenet_v1", token_type="radix", radix_base=16,
             rnn_size=32, rnn_word_size=16, attn_num_heads=2)


def _captioner_tree():
    """A MobileNet-V1 captioner's tree in comic_tpu's layout: the zoo tree
    of the encoder and the port's seeded decoder."""
    spec = tcap.build_model_spec(Config(**SMALL), Vocabulary(dict(WTOI)))
    tree = bridge.to_jax_tree(tcap.init_params(spec, device="cpu"))
    tree["encoder"]["cnn"] = jax.tree_util.tree_map(
        np.asarray, zoo_tree("mobilenet_v1"))
    return spec, tree


def _equal(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_compact_checkpoints_cross_load(tmp_path):
    """comic_tpu's compact msgpack loads in the port, and the port's in
    comic_tpu."""
    spec, tree = _captioner_tree()
    _, jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 3, tree)
    loaded = tckpt.load_compact(jpath, tcap.init_params(spec, device="cpu"))
    _equal(bridge.to_jax_tree(loaded), tree)
    tpath = tckpt.save_compact(str(tmp_path / "t"), 3,
                               bridge.from_jax_tree(tree, "cpu"))
    _equal(jax.tree_util.tree_map(np.asarray,
                                  jckpt.load_compact(tpath, tree)), tree)


def test_orbax_checkpoints_cross_load(tmp_path):
    """The port's Orbax compact checkpoint loads in comic_tpu, and
    comic_tpu's in the port."""
    pytest.importorskip("tensorstore")
    spec, tree = _captioner_tree()
    saver = tckpt.make_saver("orbax")
    saver.save(str(tmp_path / "t"), 5, bridge.from_jax_tree(tree, "cpu"))
    saver.close()
    _equal(jax.tree_util.tree_map(
        np.asarray, jckpt.load_compact(str(tmp_path / "t"), tree)), tree)
    jsaver = jckpt.make_saver("orbax")
    jsaver.save(str(tmp_path / "j"), 5, tree)
    jsaver.close()
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))
    loaded = tckpt.load_compact(str(tmp_path / "j"),
                                tcap.init_params(spec, device="cpu"))
    _equal(bridge.to_jax_tree(loaded), tree)


def _x(shape, seed=3):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, nchw(x)


def test_bf16_layers_mobilenet_v1():
    """Conv2d_0, then the first depthwise and pointwise convs (relu6), each
    on the input comic_tpu's previous layer gave."""
    tree = zoo_tree("mobilenet_v1")
    params = bridge.from_jax_tree(tree, "cpu")
    img, timg = _x((2, 17, 17, 3))
    _, want = jmb1.apply(tree, img, final_endpoint="Conv2d_1_pointwise",
                         dtype=BF16)
    x, prev = timg, None
    for name, stride in (("Conv2d_0", 2), ("Conv2d_1_depthwise", 1),
                         ("Conv2d_1_pointwise", 1)):
        if prev is not None:
            x = nchw(np.asarray(want[prev]))
        got = tmb1.conv_bn_relu6(params[name], x, stride, torch.bfloat16,
                                 depthwise=name.endswith("depthwise"))
        bf16_close(got, want[name], name)
        prev = name


def test_bf16_layers_mobilenet_v2():
    """A strided depthwise conv, a linear projection, and whole inverted
    residuals (expanded_conv_2 adds its input back), each on the input
    comic_tpu's previous block gave."""
    tree = zoo_tree("mobilenet_v2")
    params = bridge.from_jax_tree(tree, "cpu")
    blk_j, blk_t = tree["expanded_conv_1"], params["expanded_conv_1"]
    x, tx = _x((2, 9, 9, 96))
    dw = blk_j["depthwise"]["depthwise_weights"]
    kernel = jnp.transpose(dw, (0, 1, 3, 2)).reshape(3, 3, 1, 96)
    bf16_close(tmb1.conv_bn_relu6(blk_t["depthwise"], tx, 2, torch.bfloat16,
                                  depthwise=True),
               jmb2._conv_bn(blk_j["depthwise"], x, 2, BF16, groups=96,
                             kernel=kernel), "depthwise")
    bf16_close(tlayers.conv_bn(blk_t["project"], tx, 1, tmb2.BN_EPS,
                               torch.bfloat16, act=None),
               jmb2._conv_bn(blk_j["project"], x, 1, BF16, relu6=False),
               "project")
    img, _ = _x((2, 17, 17, 3))
    _, want = jmb2.apply(tree, img, final_endpoint="expanded_conv_2",
                         dtype=BF16)
    for prev, name, stride in (("Conv", "expanded_conv", 1),
                               ("expanded_conv", "expanded_conv_1", 2),
                               ("expanded_conv_1", "expanded_conv_2", 1)):
        got = tmb2.inverted_residual(params[name],
                                     nchw(np.asarray(want[prev])), stride,
                                     torch.bfloat16)
        bf16_close(got, want[name], name)
