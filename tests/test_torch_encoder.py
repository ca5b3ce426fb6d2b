"""comic_tpu_torch's Inception-V1 and encode_images against comic_tpu at a
64x64 input in float32."""

import jax
import numpy as np
import pytest
import torch

from comic_tpu.models import encoders as jenc
from comic_tpu.models import inception_v1 as jinc
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import encoders as tenc
from comic_tpu_torch.models import inception_v1 as tinc

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


def test_registry_covers_comic_tpu():
    """Every comic_tpu encoder is either ported or refused by name."""
    for name in jenc.available_encoders():
        if name == "inception_v1":
            assert tenc.get_encoder(name).fm_channels == \
                jenc.get_encoder(name).fm_channels
        else:
            with pytest.raises(NotImplementedError, match="not yet ported"):
                tenc.get_encoder(name)
    with pytest.raises(ValueError):
        tenc.get_encoder("no_such_net")
