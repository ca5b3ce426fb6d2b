"""comic_tpu_torch's Inception-V1 and encode_images against comic_tpu at a
64x64 input in float32, the registry of the encoder zoo, and the helpers
of the zoo's tests (tests/test_torch_zoo_*.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import encoders as jenc
from comic_tpu.models import inception_v1 as jinc
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import encoders as tenc
from comic_tpu_torch.models import inception_v1 as tinc
from comic_tpu_torch.models import layers as tlayers

torch.set_num_threads(1)


def _close(got, want, err_msg=""):
    """16 conv layers deep in float32 the two convolution libraries sum in
    different orders: values agree to 1e-5 of each endpoint's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


def _perturbed_cnn(seed=0):
    """comic_tpu's init tree with BN statistics moved off their defaults."""
    tree = jax.tree_util.tree_map(
        np.asarray, jinc.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(d):
        for k, v in d.items():
            if k == "BatchNorm":
                n = v["beta"].shape[0]
                v["beta"] = rng.normal(0, 0.2, n).astype(np.float32)
                v["moving_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                v["moving_variance"] = rng.uniform(
                    0.5, 1.5, n).astype(np.float32)
            elif isinstance(v, dict):
                walk(v)

    walk(tree)
    return tree


@pytest.fixture(scope="module")
def cnn():
    tree = _perturbed_cnn()
    images = np.random.default_rng(1).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)
    return tree, images


def test_endpoints_match(cnn):
    tree, images = cnn
    _, want = jinc.apply(tree, images)
    _, got = tinc.apply(bridge.from_jax_tree(tree, "cpu"),
                        torch.from_numpy(images).permute(0, 3, 1, 2))
    assert list(got) == list(want)
    for name in want:
        _close(got[name].permute(0, 2, 3, 1).numpy(), want[name], name)


@pytest.mark.parametrize("legacy", [False, True])
def test_encode_images(cnn, legacy):
    tree, images = cnn
    params = {"cnn": tree}
    if legacy:
        rng = np.random.default_rng(2)
        params["LN_tanh"] = {
            "scale": rng.normal(1, 0.1, 1024).astype(np.float32),
            "bias": rng.normal(0, 0.1, 1024).astype(np.float32)}
        params["im_embed"] = {
            "kernel": rng.normal(0, 0.05, (1024, 1024)).astype(np.float32)}
    want_emb, want_fm = jenc.encode_images(params, images, "inception_v1",
                                           legacy=legacy)
    got_emb, got_fm = tenc.encode_images(
        bridge.from_jax_tree(params, "cpu"),
        torch.from_numpy(images).permute(0, 3, 1, 2), "inception_v1",
        legacy=legacy)
    assert got_fm.shape == (2, 16, 832)  # Mixed_4f at 64x64: 4x4 positions
    _close(got_fm.numpy(), want_fm)
    _close(got_emb.numpy(), want_emb)


def test_init_tree_matches_comic_tpu():
    want = jax.tree_util.tree_map(np.asarray,
                                  jinc.init_params(jax.random.PRNGKey(0)))
    got = bridge.to_jax_tree(tinc.init_params(torch.Generator().manual_seed(0)))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_bf16_layers_inception_v1():
    """The 7x7/2 stem conv and a mixed block (merged 1x1s, 3x3s, the pool
    branch) in bfloat16, each fed the same input in both packages
    (bf16_close below)."""
    tree = _perturbed_cnn()
    params = bridge.from_jax_tree(tree, "cpu")
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 17, 17, 3)).astype(np.float32)
    bf16_close(tlayers.conv_bn(params["Conv2d_1a_7x7"], nchw(img), 2,
                               tinc.BN_EPS, torch.bfloat16),
               jinc._conv_bn_relu(tree["Conv2d_1a_7x7"], img, 2,
                                  jnp.bfloat16), "Conv2d_1a_7x7")
    x = rng.normal(size=(2, 7, 7, 192)).astype(np.float32)
    bf16_close(tinc._mixed_block(params["Mixed_3b"], nchw(x),
                                 torch.bfloat16),
               jinc._mixed_block(tree["Mixed_3b"], x, jnp.bfloat16),
               "Mixed_3b")


def test_registry_covers_comic_tpu():
    """Every comic_tpu encoder resolves in the port, with comic_tpu's
    endpoint table, feature width, image size, attention endpoint and
    preprocessing; an unknown name is refused by both."""
    assert tenc.available_encoders() == jenc.available_encoders()
    assert len(tenc.available_encoders()) == 20
    for name in jenc.available_encoders():
        got, want = tenc.get_encoder(name), jenc.get_encoder(name)
        assert got.name == want.name == name
        for field in ("fm_channels", "feature_dim", "default_image_size",
                      "default_fm_endpoint", "preprocessing"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    for get in (tenc.get_encoder, jenc.get_encoder):
        with pytest.raises(ValueError, match="unknown"):
            get("no_such_net")


# --- the encoder zoo's checks, shared by tests/test_torch_zoo_*.py ----------

def zoo_tree(name, seed=0):
    """comic_tpu's init tree of encoder ``name`` (its structure, shapes and
    dtypes: jax.eval_shape of its init_params) filled with seeded values:
    kernels normal with variance 2 / fan-in (a depthwise kernel's fan-in is
    k * k), BN scales and variances in [0.5, 1.5], means, offsets and
    biases normal(0, 0.2). comic_tpu's own draws, run op by op, take 10-30
    s a net here; these take one."""
    shapes = jax.eval_shape(jenc.get_encoder(name).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key, shape = path[-1].key.rsplit("/", 1)[-1], leaf.shape
        if key == "depthwise_weights":
            std = math.sqrt(2.0 / (shape[0] * shape[1]))
        elif key in ("weights", "pointwise_weights"):
            std = math.sqrt(2.0 / math.prod(shape[:-1]))
        elif key in ("gamma", "moving_variance"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            std = 0.2
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _legacy_head(name):
    """Seeded LN-tanh and image-embedding params of the legacy head."""
    dim = jenc.get_encoder(name).feature_dim
    rng = np.random.default_rng(2)
    return {"LN_tanh": {"scale": rng.normal(1, 0.1, dim).astype(np.float32),
                        "bias": rng.normal(0, 0.1, dim).astype(np.float32)},
            "im_embed": {"kernel": rng.normal(
                0, 0.05, (dim, 1024)).astype(np.float32)}}


def zoo_case(name, size, batch=2):
    """(name, tree, NHWC images in [-1, 1], comic_tpu's float32 results at
    them: {"endpoints": ..., "plain"/"legacy": encode_images with the
    legacy head off/on}), all from one jitted call (one compile of the
    net)."""
    tree = zoo_tree(name)
    images = np.random.default_rng(1).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)

    def run(tree, head, images):
        _, endpoints = jenc.get_encoder(name).apply(tree, images)
        return {"endpoints": endpoints,
                "plain": jenc.encode_images({"cnn": tree}, images, name),
                "legacy": jenc.encode_images(dict(head, cnn=tree), images,
                                             name, legacy=True)}

    want = jax.jit(run)(tree, _legacy_head(name), images)
    return name, tree, images, jax.tree_util.tree_map(np.asarray, want)


def nchw(images):
    """NHWC numpy (a read-only view of a JAX array too) -> NCHW tensor."""
    return torch.from_numpy(np.array(images)).permute(0, 3, 1, 2)


def check_endpoints(case):
    """Every endpoint of the port's apply equals comic_tpu's at _close."""
    name, tree, images, want = case
    _, got = tenc.get_encoder(name).apply(bridge.from_jax_tree(tree, "cpu"),
                                          nchw(images))
    assert sorted(got) == sorted(want["endpoints"])
    for ep, w in want["endpoints"].items():
        _close(got[ep].permute(0, 2, 3, 1).numpy(), w, f"{name} {ep}")


def check_encode_images(case, legacy):
    """encode_images (pooled embedding, legacy head on or off, and the
    flattened default attention endpoint) equals comic_tpu's."""
    name, tree, images, want = case
    spec = jenc.get_encoder(name)
    params = dict(_legacy_head(name), cnn=tree) if legacy else {"cnn": tree}
    want_emb, want_fm = want["legacy" if legacy else "plain"]
    got_emb, got_fm = tenc.encode_images(bridge.from_jax_tree(params, "cpu"),
                                         nchw(images), name, legacy=legacy)
    assert got_fm.shape == want_fm.shape
    assert got_fm.shape[2] == spec.fm_channels[spec.default_fm_endpoint]
    _close(got_fm.numpy(), want_fm, f"{name} attention memory")
    _close(got_emb.numpy(), want_emb, f"{name} embedding")


def check_init_tree(name):
    """The port's init tree, in comic_tpu's layout, has comic_tpu's
    structure, shapes and dtypes."""
    want = jax.eval_shape(jenc.get_encoder(name).init, jax.random.PRNGKey(0))
    got = bridge.to_jax_tree(
        tenc.get_encoder(name).init(torch.Generator().manual_seed(0)))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def check_round_trip(case):
    """from_jax_tree then to_jax_tree gives back every leaf bit for bit."""
    tree = case[1]
    back = bridge.to_jax_tree(bridge.from_jax_tree(tree, "cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# bfloat16 layers, one layer fed the same input in both packages: the
# roundings are placed alike where the mean difference stays below
# BF16_MEAN of the mean magnitude (a rounding of the input, the kernel or
# the output missed or added moves it to ~1e-3); a few outputs may still
# land one bfloat16 step apart where the two convolution libraries' float32
# sums straddle a rounding boundary, so the largest difference is held to
# two steps (BF16_MAX) of the largest magnitude. comic_tpu is run op by
# op: jitted, XLA on the CPU drops the rounding of a bfloat16 convolution's
# output before its float32 cast, which its code (and the port) keeps.
BF16_MEAN, BF16_MAX = 1e-5, 2.0 ** -7


def bf16_close(got, want, what=""):
    got = got.permute(0, 2, 3, 1).numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    diff = np.abs(got - want)
    assert diff.mean() <= BF16_MEAN * np.abs(want).mean(), \
        (what, diff.mean() / np.abs(want).mean())
    assert diff.max() <= BF16_MAX * np.abs(want).max(), \
        (what, diff.max() / np.abs(want).max())
