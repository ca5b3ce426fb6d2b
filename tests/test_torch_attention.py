"""comic_tpu_torch attention against comic_tpu, and the plain versions of
the two CUDA kernels against the Pallas kernels they replace (run in
interpret mode, as tests/test_ops.py runs them) and against the jnp steps.

Tolerances: float32 at rtol 1e-5 / atol 1e-6. Against the jnp decode steps
the plain versions round the query and the alignments to bfloat16 where
those steps do, so bfloat16 keys compare at rtol = atol = 1e-4: what is
left is float32 summation order and K2's two-pass LayerNorm statistics
against the closed form. Against the Pallas kernels, bfloat16 keys compare
at rtol 2e-2 / atol 2e-3, as tests/test_ops.py allows: the Pallas kernels
keep the query and the alignments in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.models import attention as jatt
from comic_tpu.models.layers import dense_apply as jdense
from comic_tpu.models.layers import split_heads as jsplit
from comic_tpu.ops.fused_attention import fused_add_ln_attention as pallas_fused
from comic_tpu.ops.grouped_attention import (
    grouped_add_ln_attention as pallas_grouped,
)
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import attention as tatt
from comic_tpu_torch.ops import fused_attention as k2
from comic_tpu_torch.ops import grouped_attention as k1

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-4, atol=1e-4)  # against the jnp decode steps
# against the Pallas kernels, which keep the query and alignments in f32
BF16_PALLAS = dict(rtol=2e-2, atol=2e-3)
B, K, L, U, H, C = 3, 3, 7, 16, 4, 12


def _setup(alignment="add_LN", probability="softmax", projection="tied",
           context_layer=False, seed=0, dims=(B, K, L, U, H, C)):
    B, K, L, U, H, C = dims
    kw = dict(num_units=U, num_heads=H, memory_channels=C,
              alignment=alignment, probability=probability,
              fm_projection=projection, context_layer=context_layer)
    jcfg, tcfg = jatt.AttentionConfig(**kw), tatt.AttentionConfig(**kw)
    p = jax.tree_util.tree_map(
        np.asarray, jatt.attention_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    if "ln" in p:  # move the LayerNorm affine and temperature off init
        p["ln"]["scale"] = rng.normal(1, 0.3, U).astype(np.float32)
        p["ln"]["bias"] = rng.normal(0, 0.3, U).astype(np.float32)
        p["softmax_temperature"] = np.float32(3.5)
    fm = rng.normal(size=(B, L, C)).astype(np.float32)
    q = rng.normal(size=(B, K, U)).astype(np.float32)
    return jcfg, tcfg, p, bridge.from_jax_tree(p, "cpu"), fm, q


def _memories(jcfg, tcfg, p, tp, fm):
    jmem = jatt.precompute(p, jcfg, fm)
    tmem = tatt.precompute(tp, tcfg, torch.from_numpy(fm))
    for got, want in zip(tmem, jmem):
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want, **F32)
    return jmem, tmem


CASES = [(a, pr, proj) for a in ("add_LN", "add", "dot")
         for pr in ("softmax", "sigmoid")
         for proj in ("tied", "independent", None)]


@pytest.mark.parametrize("alignment,probability,projection", CASES)
def test_attend_matches(alignment, probability, projection):
    jcfg, tcfg, p, tp, fm, q = _setup(alignment, probability, projection)
    jmem, tmem = _memories(jcfg, tcfg, p, tp, fm)
    want_ctx, want_align = jatt.attend(p, jcfg, q[:, 0], jmem)
    got_ctx, got_align = tatt.attend(tp, tcfg, torch.from_numpy(q[:, 0]),
                                     tmem)
    np.testing.assert_allclose(got_align.numpy(), want_align, **F32)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **F32)


@pytest.mark.parametrize("alignment,probability,projection", CASES)
def test_attend_grouped_matches(alignment, probability, projection):
    jcfg, tcfg, p, tp, fm, q = _setup(alignment, probability, projection)
    jmem, tmem = _memories(jcfg, tcfg, p, tp, fm)
    want_ctx, want_align = jatt.attend_grouped(p, jcfg, q, jmem)
    got_ctx, got_align = tatt.attend_grouped(tp, tcfg, torch.from_numpy(q),
                                             tmem)
    np.testing.assert_allclose(got_align.numpy(), want_align, **F32)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **F32)


@pytest.mark.parametrize("projection", ["tied", None])
def test_context_layer(projection):
    jcfg, tcfg, p, tp, fm, q = _setup(projection=projection,
                                      context_layer=True)
    jmem, tmem = _memories(jcfg, tcfg, p, tp, fm)
    want = jatt.attend_grouped(p, jcfg, q, jmem)[0]
    got = tatt.attend_grouped(tp, tcfg, torch.from_numpy(q), tmem)[0]
    np.testing.assert_allclose(got.numpy(), want, **F32)
    want = jatt.attend(p, jcfg, q[:, 0], jmem)[0]
    got = tatt.attend(tp, tcfg, torch.from_numpy(q[:, 0]), tmem)[0]
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_attend_alignment_dropout_mask():
    """An injected keep-mask drops and rescales the maps the context sees,
    and the dropped maps are returned (ops_rnn.py:696-745)."""
    jcfg, tcfg, p, tp, fm, q = _setup()
    jmem, tmem = _memories(jcfg, tcfg, p, tp, fm)
    mask = np.random.default_rng(5).uniform(size=(B, H, L)) < 0.7
    align = np.asarray(jatt.attend(p, jcfg, q[:, 0], jmem)[1])
    dropped = np.where(mask, align / 0.7, 0.0).astype(np.float32)
    values = np.asarray(jmem.values)
    want_ctx = np.einsum("bhl,bhld->bhd", dropped, values).reshape(B, -1)
    got_ctx, got_align = tatt.attend(
        tp, tcfg, torch.from_numpy(q[:, 0]), tmem,
        alignments_keep_mask=torch.from_numpy(mask),
        alignments_keep_prob=0.7)
    np.testing.assert_allclose(got_align.numpy(), dropped, **F32)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **F32)


# --- K1 / K2 plain versions ----------------------------------------------------

def _kernel_inputs(keys_dtype, dims=(B, K, L, U, H, C)):
    jcfg, tcfg, p, tp, fm, q = _setup(dims=dims)
    jmem = jatt.precompute(p, jcfg, fm)
    keys = jmem.keys.astype(keys_dtype)
    k32 = keys.astype(jnp.float32)
    mean, m2 = jnp.mean(k32, -1), jnp.mean(jnp.square(k32), -1)
    pq = np.asarray(jdense(p["query_layer"], q))
    args = (p["v"], p["ln"]["scale"], p["ln"]["bias"],
            p["softmax_temperature"])
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tkeys = t(keys.astype(jnp.float32)).to(
        torch.bfloat16 if keys_dtype == jnp.bfloat16 else torch.float32)
    return (jcfg, p, q, pq, keys, mean, m2, args, t, tkeys,
            [t(a) for a in args])


@pytest.mark.parametrize("keys_dtype,tol", [(jnp.float32, F32),
                                            (jnp.bfloat16, BF16_PALLAS)])
def test_k1_plain_matches_pallas(keys_dtype, tol):
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(keys_dtype)
    want_ctx, want_align = pallas_grouped(pq, keys, mean, m2, *args,
                                          num_heads=H, interpret=True)
    before = k1.grouped_add_ln_attention.launches
    got_ctx, got_align = k1.grouped_add_ln_attention(
        t(pq), tkeys, t(mean), t(m2), *targs, num_heads=H)
    assert k1.grouped_add_ln_attention.launches == before  # CPU: no kernel
    np.testing.assert_allclose(got_align.numpy(), want_align, **tol)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **tol)


@pytest.mark.parametrize("keys_dtype,tol", [(jnp.float32, F32),
                                            (jnp.bfloat16, BF16)])
def test_k1_plain_matches_attend_grouped(keys_dtype, tol):
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(keys_dtype)
    mem = jatt.AttentionMemory(keys, jsplit(keys, H), mean, m2)
    want_ctx, want_align = jatt.attend_grouped(p, jcfg, q, mem)
    got_ctx, got_align = k1.grouped_add_ln_attention_plain(
        t(pq), tkeys, t(mean), t(m2), *targs, num_heads=H)
    assert got_ctx.dtype == got_align.dtype == torch.float32
    np.testing.assert_allclose(got_align.numpy(), want_align, **tol)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **tol)


@pytest.mark.parametrize("keys_dtype,tol", [(jnp.float32, F32),
                                            (jnp.bfloat16, BF16_PALLAS)])
def test_k2_plain_matches_pallas(keys_dtype, tol):
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(keys_dtype)
    want_ctx, want_align = pallas_fused(pq[:, 0], keys, *args, num_heads=H,
                                        interpret=True)
    before = k2.fused_add_ln_attention.launches
    got_ctx, got_align = k2.fused_add_ln_attention(
        t(pq[:, 0]), tkeys, *targs, num_heads=H)
    assert k2.fused_add_ln_attention.launches == before
    np.testing.assert_allclose(got_align.numpy(), want_align, **tol)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **tol)


@pytest.mark.parametrize("keys_dtype,tol", [(jnp.float32, F32),
                                            (jnp.bfloat16, BF16)])
def test_k2_plain_matches_attend(keys_dtype, tol):
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(keys_dtype)
    mem = jatt.AttentionMemory(keys, jsplit(keys, H), mean, m2)
    want_ctx, want_align = jatt.attend(p, jcfg, q[:, 0], mem)
    got_ctx, got_align = k2.fused_add_ln_attention_plain(
        t(pq[:, 0]), tkeys, *targs, num_heads=H)
    np.testing.assert_allclose(got_align.numpy(), want_align, **tol)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **tol)


@pytest.mark.parametrize("keys_dtype,tol", [(jnp.float32, F32),
                                            (jnp.bfloat16, BF16)])
def test_k1_plain_matches_attend_grouped_beam7(keys_dtype, tol):
    """Beam 7, the SCST rollout's: 7 queries per image over one memory."""
    dims = (B, 7, L, U, H, C)
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(keys_dtype, dims)
    mem = jatt.AttentionMemory(keys, jsplit(keys, H), mean, m2)
    want_ctx, want_align = jatt.attend_grouped(p, jcfg, q, mem)
    got_ctx, got_align = k1.grouped_add_ln_attention(
        t(pq), tkeys, t(mean), t(m2), *targs, num_heads=H)
    assert got_align.shape == (B, 7, H, L)
    np.testing.assert_allclose(got_align.numpy(), want_align, **tol)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **tol)


def test_k1_plain_matches_attend_grouped_main_width():
    """The main path's widths (L=196, U=512, H=8, beam 3) in bfloat16, at
    batch 1: XLA's CPU runtime refuses the reference's batched bf16 context
    product at these widths for a batch above 1."""
    dims = (1, 3, 196, 512, 8, 64)
    jcfg, p, q, pq, keys, mean, m2, args, t, tkeys, targs = \
        _kernel_inputs(jnp.bfloat16, dims)
    mem = jatt.AttentionMemory(keys, jsplit(keys, 8), mean, m2)
    want_ctx, want_align = jatt.attend_grouped(p, jcfg, q, mem)
    got_ctx, got_align = k1.grouped_add_ln_attention_plain(
        t(pq), tkeys, t(mean), t(m2), *targs, num_heads=8)
    np.testing.assert_allclose(got_align.numpy(), want_align, **BF16)
    np.testing.assert_allclose(got_ctx.numpy(), want_ctx, **BF16)
