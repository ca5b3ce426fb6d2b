"""comic_tpu_torch layers, cells, embedding and eval preprocessing against
comic_tpu on the same numpy inputs (float32, 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.data import preprocessing as jprep
from comic_tpu.models import cells as jcells
from comic_tpu.models import inception_v1 as jinc
from comic_tpu.models import layers as jlayers
from comic_tpu.models.attention import AttentionConfig as JAttentionConfig
from comic_tpu.models.decoder import DecoderConfig as JDecoderConfig
from comic_tpu.models.decoder import embed_ids as jembed_ids
from comic_tpu_torch import params as bridge
from comic_tpu_torch.data import preprocessing as tprep
from comic_tpu_torch.models import cells as tcells
from comic_tpu_torch.models import layers as tlayers
from comic_tpu_torch.models.attention import AttentionConfig
from comic_tpu_torch.models.decoder import DecoderConfig, embed_ids

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _conv_params(rng, k, cin, cout):
    return {
        "weights": rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32),
        "BatchNorm": {
            "beta": rng.normal(0, 0.5, cout).astype(np.float32),
            "moving_mean": rng.normal(0, 0.5, cout).astype(np.float32),
            "moving_variance": rng.uniform(0.5, 2, cout).astype(np.float32),
        },
    }


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_dense_apply(rng, dtype):
    p = {"kernel": rng.normal(size=(24, 40)).astype(np.float32),
         "bias": rng.normal(size=40).astype(np.float32)}
    x = rng.normal(size=(5, 24)).astype(np.float32)
    want = jlayers.dense_apply(p, x, dtype=dtype and jnp.bfloat16)
    got = tlayers.dense_apply({k: _t(v) for k, v in p.items()}, _t(x),
                              dtype=dtype and torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("activation", [None, "tanh"])
def test_layer_norm_apply(rng, activation):
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    x = rng.normal(2.0, 3.0, size=(4, 6, 32)).astype(np.float32)
    want = jlayers.layer_norm_apply(p, x, activation=activation and jnp.tanh)
    got = tlayers.layer_norm_apply({k: _t(v) for k, v in p.items()}, _t(x),
                                   activation=activation and torch.tanh)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_combine_heads(rng):
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    got = tlayers.split_heads(_t(x), 3)
    np.testing.assert_array_equal(got.numpy(), jlayers.split_heads(x, 3))
    np.testing.assert_array_equal(tlayers.combine_heads(got).numpy(), x)


@pytest.mark.parametrize("size,k,stride", [
    (16, 7, 2), (15, 7, 2), (9, 3, 2), (8, 3, 1), (7, 1, 1), (10, 1, 2)])
def test_conv2d_same(rng, size, k, stride):
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tlayers.conv2d(_nchw(x), _t(w.transpose(3, 2, 0, 1)), stride)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("kh,kw,stride,padding", [
    (1, 7, 1, "SAME"), (7, 1, 1, "SAME"), (3, 3, 2, "VALID"),
    (1, 3, 2, "SAME"), (5, 5, 1, "VALID")])
def test_conv2d_any_kernel_and_padding(rng, kh, kw, stride, padding):
    """The factorized 1x7/7x1 kernels and VALID convs of the zoo."""
    x = rng.normal(size=(2, 12, 11, 3)).astype(np.float32)
    w = rng.normal(size=(kh, kw, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tlayers.conv2d(_nchw(x), _t(w.transpose(3, 2, 0, 1)), stride,
                         padding)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("size,k,stride,padding", [
    (8, 3, 1, "SAME"), (9, 3, 2, "SAME"), (8, 3, 2, "SAME"),
    (7, 3, 2, "VALID"), (5, 5, 1, "SAME")])
def test_avg_pool_divides_by_in_bounds_count(rng, size, k, stride, padding):
    """TF's average pool (comic_tpu's layers.avg_pool_same): a window at the
    edge divides by its in-bounds elements, with TF's asymmetric pads."""
    x = rng.normal(size=(2, size, size + 1, 4)).astype(np.float32)
    want = jlayers.avg_pool_same(x, k, stride, padding)
    got = tlayers.avg_pool(_nchw(x), k, stride, padding)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("size,k,stride", [
    (8, 3, 2), (9, 3, 2), (7, 3, 1), (7, 2, 2), (8, 2, 2), (112, 3, 2)])
def test_max_pool_same(rng, size, k, stride):
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    want = jinc._max_pool(x, k, stride)
    got = tlayers.max_pool(_nchw(x), k, stride)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_same_padding_is_tf_rule():
    # the 7x7/2 stem on 224 pads 2/3, the 3x3/2 pool on 112 pads 0/1
    assert tlayers.same_padding(224, 7, 2) == (2, 3)
    assert tlayers.same_padding(112, 3, 2) == (0, 1)
    assert tlayers.same_padding(14, 3, 1) == (1, 1)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu(rng, stride):
    p = _conv_params(rng, 3, 4, 6)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    want = jinc._conv_bn_relu(p, x, stride)
    got = tlayers.conv_bn(bridge.from_jax_tree(p, "cpu"), _nchw(x),
                          stride, jinc.BN_EPS)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_merged_1x1_bn_relu(rng):
    parts = [_conv_params(rng, 1, 8, c) for c in (3, 5, 2)]
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    want = jlayers.merged_1x1_bn_relu(parts, x, jinc.BN_EPS)
    got = tlayers.merged_1x1_bn_relu(
        [bridge.from_jax_tree(q, "cpu") for q in parts], _nchw(x),
        jinc.BN_EPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), w, **TOL)
    with pytest.raises(ValueError):
        tlayers.merged_1x1_bn_relu(
            [bridge.from_jax_tree(_conv_params(rng, 3, 8, 2), "cpu")],
            _nchw(x), jinc.BN_EPS)


@pytest.mark.parametrize("name", ["LSTM", "LN_LSTM", "GRU"])
def test_cell_step(name):
    jcell = jcells.Cell(name, 6, 8)
    p = jax.tree_util.tree_map(np.asarray, jcell.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), p)
    x = rng.normal(size=(3, 6)).astype(np.float32)
    h = rng.normal(size=(3, 8)).astype(np.float32)
    c = rng.normal(size=(3, 8)).astype(np.float32)
    jstate = h if name == "GRU" else jcells.LSTMState(c, h)
    tstate = _t(h) if name == "GRU" else tcells.LSTMState(_t(c), _t(h))
    want_out, want_state = jcell.step(p, x, jstate)
    got_out, got_state = tcells.Cell(name, 6, 8).step(
        bridge.from_jax_tree(p, "cpu"), _t(x), tstate)
    np.testing.assert_allclose(got_out.numpy(), want_out, **TOL)
    if name == "GRU":
        got_state, want_state = [got_state], [want_state]
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(np.asarray(g), w, **TOL)


@pytest.mark.parametrize("token_type", ["radix", "word"])
def test_embed_ids_pad_is_zero_row(rng, token_type):
    table = rng.normal(size=(7, 4)).astype(np.float32)
    ids = np.array([[0, 3, 6, -1], [-1, -1, 2, 5]], np.int32)
    jattn = JAttentionConfig(num_units=4, num_heads=2, memory_channels=4)
    tattn = AttentionConfig(num_units=4, num_heads=2, memory_channels=4)
    want = jembed_ids({"embedding": table},
                      JDecoderConfig(token_type, 7, attention=jattn), ids)
    got = embed_ids({"embedding": _t(table)},
                    DecoderConfig(token_type, 7, attention=tattn),
                    _t(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    if token_type == "radix":
        assert not got[0, 3].any()


@pytest.mark.parametrize("out", [(224, 224), (64, 64), (200, 256)])
def test_preprocess_batch(rng, out):
    imgs = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    want = jprep.preprocess_batch(imgs, jax.random.PRNGKey(0), *out, False)
    got = tprep.preprocess_batch(imgs, *out, torch.device("cpu"))
    assert got.shape == (2, 3) + out
    np.testing.assert_array_equal(_nhwc(got), want)


def test_central_crop_or_pad_pads(rng):
    img = rng.uniform(size=(5, 9, 3)).astype(np.float32)
    want = jprep.central_crop_or_pad(img, 8, 6)
    got = tprep.central_crop_or_pad(_t(img)[None], 8, 6)[0]
    np.testing.assert_array_equal(got.numpy(), want)
