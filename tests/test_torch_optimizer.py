"""comic_tpu_torch's schedules and optimizer against comic_tpu's
(training/schedule.py, training/optimizer.py): the same learning rates,
the same updates from the same gradients, and the same optimizer state in
the layout flax writes for comic_tpu's optax chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from comic_tpu.training import optimizer as jopt
from comic_tpu.training import schedule as jsched
from comic_tpu_torch import params as bridge
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import schedule as tsched

torch.set_num_threads(1)

# float32 on both sides; they differ only in the rounding of a few float32
# operations per update (pow, sqrt, a fused multiply-add where XLA fuses
# one). Elementwise 1e-6 relative, and 1e-6 of the leaf's largest
# magnitude absolute, for entries near 0 whose rounding follows the
# leaf's larger terms.
RTOL = 1e-6


def _close(got, want, msg=""):
    want = np.asarray(want)
    atol = RTOL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("make", [
    lambda m: (jsched.cosine_schedule(1e-2, 1e-5, 30),
               tsched.cosine_schedule(1e-2, 1e-5, 30)),
    lambda m: (jsched.legacy_halving_schedule(1e-3, 4, 2, lr_end=2e-4),
               tsched.legacy_halving_schedule(1e-3, 4, 2, lr_end=2e-4)),
    lambda m: (jsched.legacy_halving_schedule(1e-3, 3, 1),
               tsched.legacy_halving_schedule(1e-3, 3, 1)),
])
def test_schedules_match(make):
    """50 steps, past the cosine's end and through several halvings."""
    j, t = make(None)
    for step in range(50):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=RTOL)


def _params(rng):
    """A small tree with comic_tpu's scopes: a conv (HWIO here) and BN
    statistics under encoder/cnn, a dense layer under decoder."""
    return {
        "encoder": {"cnn": {"Conv2d_1a_7x7": {
            "weights": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
            "BatchNorm": {"beta": rng.normal(size=4).astype(np.float32),
                          "moving_mean": np.zeros(4, np.float32),
                          "moving_variance": np.ones(4, np.float32)}}}},
        "decoder": {"dense": {
            "kernel": rng.normal(size=(5, 3)).astype(np.float32),
            "bias": rng.normal(size=3).astype(np.float32)}},
    }


CASES = {
    "adam_frozen_cnn": dict(freeze_scopes="encoder/cnn", adam_epsilon=1e-2),
    "adam_all": dict(freeze_scopes="", adam_epsilon=1e-2),
    "adam_multiplier_clip": dict(freeze_scopes="", adam_epsilon=1e-2,
                                 cnn_grad_multiplier=0.3,
                                 clip_gradient_norm=0.5),
    "adam_eps_1e-6": dict(freeze_scopes="", adam_epsilon=1e-6),
    "sgd_frozen_cnn": dict(freeze_scopes="encoder/cnn", optimiser="sgd"),
    "sgd_clip": dict(freeze_scopes="", optimiser="sgd",
                     clip_gradient_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_updates_match_optax(case):
    """5 updates from shared gradients: parameters, moments and counts of
    the port equal comic_tpu's optax chain, in flax's state layout."""
    kw = CASES[case]
    rng = np.random.default_rng(0)
    jparams = _params(rng)
    sched_j = jsched.cosine_schedule(1e-2, 1e-4, 8)
    opt_j, mask = jopt.build_optimizer(jparams, sched_j, **kw)
    st = opt_j.init(jparams)
    tparams = bridge.from_jax_tree(jparams, "cpu")
    opt_t = topt.Optimizer(tparams, tsched.cosine_schedule(1e-2, 1e-4, 8),
                           **kw)
    topt.set_trainable(tparams, opt_t.mask)
    assert opt_t.mask == mask
    p = jparams
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), p)
        upd, st = opt_j.update(grads, st, p)
        p = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b), p, upd)
        tg = bridge.from_jax_tree(grads, "cpu")
        for path, v in topt.tree_items(tparams):
            if v.requires_grad:
                v.grad = topt.tree_get(tg, path).clone()
        opt_t.step(tparams)
    got = bridge.to_jax_tree(tparams)
    for path, a in topt.tree_items(got):
        b = topt.tree_get(p, path)
        _close(a, b, topt.path_string(path))
        if not topt.tree_get(mask, path):
            np.testing.assert_array_equal(
                a, topt.tree_get(jparams, path))  # frozen: untouched
    want_state = serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, st))
    got_state = opt_t.state_dict(tparams)
    _assert_close_tree(got_state, want_state)
    # and the state reads back into a fresh optimizer
    fresh = topt.Optimizer(tparams, tsched.cosine_schedule(1e-2, 1e-4, 8),
                           **kw)
    fresh.load_state_dict(want_state, tparams)
    assert fresh.count == 5
    _assert_close_tree(fresh.state_dict(tparams), want_state)


def _assert_close_tree(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close_tree(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want)


def test_masks_and_l2_match():
    rng = np.random.default_rng(1)
    jparams = _params(rng)
    tparams = bridge.from_jax_tree(jparams, "cpu")
    for scopes in ("encoder/cnn", "Model/encoder/cnn", "", "decoder,cnn"):
        mask = jopt.trainable_mask(jparams, scopes)
        assert topt.trainable_mask(tparams, scopes) == mask
        np.testing.assert_allclose(
            float(topt.masked_l2_loss(tparams, mask, 1e-2)),
            float(jopt.masked_l2_loss(jparams, mask, 1e-2)), rtol=1e-6)
    assert topt.scope_mask(tparams, "encoder/cnn") == \
        jopt.scope_mask(jparams, "encoder/cnn")
    # BN moving statistics are never trainable, even with nothing frozen
    bn = topt.trainable_mask(tparams, "")["encoder"]["cnn"][
        "Conv2d_1a_7x7"]["BatchNorm"]
    assert bn == {"beta": True, "moving_mean": False,
                  "moving_variance": False}


def test_frozen_leaves_get_no_gradient_and_no_state():
    rng = np.random.default_rng(2)
    tparams = bridge.from_jax_tree(_params(rng), "cpu")
    opt = topt.Optimizer(tparams, lambda s: 1e-3,
                         freeze_scopes="encoder/cnn")
    topt.set_trainable(tparams, opt.mask)
    conv = tparams["encoder"]["cnn"]["Conv2d_1a_7x7"]
    assert not conv["weights"].requires_grad
    assert tparams["decoder"]["dense"]["kernel"].requires_grad
    assert len(opt.moments["mu"]) == 2  # the decoder's kernel and bias
    state = opt.state_dict(tparams)
    mu = state["1"]["inner_state"]["0"]["mu"]
    assert mu["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"] == {}
    with pytest.raises(ValueError, match="optimizer state"):
        opt.load_state_dict({"0": {}}, tparams)
    with pytest.raises(ValueError, match="Unknown optimiser"):
        topt.Optimizer(tparams, lambda s: 1e-3, optimiser="rmsprop")
