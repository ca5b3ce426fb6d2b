"""comic_tpu_torch's cost model (utils/roofline.py) against comic_tpu's.

Every case of tests/test_roofline.py, on the port's dispatch-level count;
then the two counts side by side on the same inputs, made with numpy from
a seed: matmul_flops and conv_flops equal exactly for GEMMs, convolutions,
the tiny Inception-V1 encoder, entry(tiny=True)'s XE forward and the tiny
serve; the analytic cost K1 and K2 report equal, field by field, to
comic_tpu's count of the same part of attend_grouped / attend; and a call
through a kernel's wrapper counted once.

What differs by construction (roofline.py's docstring), pinned here:
bytes_lower holds the program's inputs and outputs only, where comic_tpu
adds each scan or while_loop body's operands once a trip; loops count as
they ran (no while_trip_count); vpu_elems follow aten's operations, not
jax's primitives (a mean is one op, not a sum and a divide).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from comic_tpu.models import attention as jatt
from comic_tpu.models import encoders as jenc
from comic_tpu.models.layers import dense_apply as jdense
from comic_tpu.models.layers import split_heads as jsplit
from comic_tpu.utils import roofline as jroof
from comic_tpu_torch import params as bridge
from comic_tpu_torch.models import encoders as tenc
from comic_tpu_torch.ops import fused_attention as k2
from comic_tpu_torch.ops import grouped_attention as k1
from comic_tpu_torch.utils.roofline import (
    H100_SXM_HBM_BYTES_PER_S,
    H100_SXM_PEAK_BF16_FLOPS,
    Cost,
    add_ln_attention_cost,
    count_costs,
    utilization_fields,
)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestExactCounts:
    def test_matmul_flops_exact(self):
        a, b = torch.zeros(64, 32), torch.zeros(32, 16)
        c = count_costs(lambda a, b: a @ b, a, b)
        assert c.matmul_flops == 2 * 64 * 32 * 16
        assert c.conv_flops == 0

    def test_batched_matmul(self):
        a, b = torch.zeros(4, 8, 6), torch.zeros(4, 6, 5)
        c = count_costs(torch.matmul, a, b)
        assert c.matmul_flops == 2 * 4 * 8 * 6 * 5

    def test_linear_reaches_addmm(self):
        x, w, b = torch.zeros(5, 12), torch.zeros(7, 12), torch.zeros(7)
        c = count_costs(F.linear, x, w, b)
        assert c.matmul_flops == 2 * 5 * 12 * 7
        assert set(c.by_primitive) == {"addmm"}

    def test_conv_flops_exact(self):
        x, w = torch.zeros(2, 3, 8, 8), torch.zeros(7, 3, 3, 3)
        c = count_costs(lambda x, w: F.conv2d(x, w, padding=1), x, w)
        # 2 * out_elems * Cin * kh * kw
        assert c.conv_flops == 2 * (2 * 8 * 8 * 7) * 3 * 9

    def test_grouped_conv_uses_per_group_channels(self):
        x, w = torch.zeros(1, 8, 8, 8), torch.zeros(8, 1, 3, 3)
        c = count_costs(lambda x, w: F.conv2d(x, w, padding=1, groups=8),
                        x, w)
        assert c.conv_flops == 2 * (1 * 8 * 8 * 8) * 1 * 9

    def test_vpu_elems_and_free_ops(self):
        a = torch.zeros(64, 16)
        c = count_costs(lambda a: torch.tanh(a).reshape(-1), a)
        assert c.vpu_elems == 64 * 16  # reshape is free

    def test_program_io_bytes(self):
        a, b = torch.zeros(64, 32), torch.zeros(32, 16)
        c = count_costs(lambda a, b: a @ b, a, b)
        assert c.bytes_lower == (64 * 32 + 32 * 16 + 64 * 16) * 4
        # the one op's operands and result
        assert c.bytes_upper == c.bytes_lower

    def test_inference_mode_counts_what_composites_are_made_of(self):
        """Under inference mode conv2d and matmul reach the dispatch mode
        undecomposed; they count as the convolution and mm they run."""
        x, w = torch.zeros(2, 3, 8, 8), torch.zeros(7, 3, 3, 3)
        a = torch.zeros(6, 5)

        @torch.inference_mode()
        def f(x, w, a):
            return F.conv2d(x, w, padding=1), torch.matmul(a, a.T)

        c = count_costs(f, x, w, a)
        assert c.conv_flops == 2 * (2 * 8 * 8 * 7) * 3 * 9
        assert c.matmul_flops == 2 * 6 * 5 * 6
        assert {"convolution", "mm"} <= set(c.by_primitive)


class TestControlFlow:
    def test_loop_counts_as_it_ran(self):
        a = torch.zeros(16, 16)

        def f(a):
            out = a
            for _ in range(7):
                out = out @ a
            return out

        assert count_costs(f, a).matmul_flops == 7 * 2 * 16 ** 3

    def test_loop_trips_replace_the_hint(self):
        """comic_tpu's while_trip_count hint: here the trips that ran. The
        loop adds nothing to bytes_lower (comic_tpu adds the body's
        operands once a trip)."""
        a = torch.zeros(16, 16)

        def f(a, trips):
            x = a
            for _ in range(trips):
                x = torch.tanh(x @ a)
            return x

        c60, c0 = count_costs(f, a, 60), count_costs(f, a, 0)
        assert c60.matmul_flops == 60 * 2 * 16 ** 3
        assert c0.matmul_flops == 0
        diff = c60 - c0
        assert diff.matmul_flops == 60 * 2 * 16 ** 3
        assert diff.vpu_elems == 60 * 16 * 16
        assert c60.bytes_lower == c0.bytes_lower == 2 * 16 * 16 * 4

    def test_checkpoint_and_nested_calls_are_counted(self):
        a = torch.zeros(16, 16)

        def inner(x):
            return x @ x

        def f(x):
            return torch.utils.checkpoint.checkpoint(
                lambda y: inner(y) + inner(y), x, use_reentrant=False)

        assert count_costs(f, a).matmul_flops == 2 * 2 * 16 ** 3

    def test_grad_counts_backward_flops(self):
        a = torch.zeros(16, 16)

        def loss(w):
            return torch.tanh(a @ w).sum()

        def grad(w):
            w = w.detach().requires_grad_()
            return torch.autograd.grad(loss(w), w)[0]

        c_f = count_costs(loss, a)
        c_g = count_costs(grad, a)
        # backward of one matmul adds ~2x the forward matmul flops
        assert c_g.matmul_flops >= 2 * c_f.matmul_flops

    def test_conv_backward_counts_both_gradients(self):
        x = torch.zeros(2, 3, 8, 8, requires_grad=True)
        w = torch.zeros(7, 3, 3, 3, requires_grad=True)

        def step(x, w):
            return torch.autograd.grad(
                F.conv2d(x, w, stride=2, padding=1).sum(), (x, w))

        forward = 2 * (2 * 4 * 4 * 7) * 3 * 9
        assert count_costs(step, x, w).conv_flops == 3 * forward

    def test_scaled_and_sub(self):
        c = Cost(10.0, 4.0, 2.0, 1.0, 8.0, {"mm": 10.0})
        s = c.scaled(3.0)
        assert s.matmul_flops == 30.0 and s.by_primitive["mm"] == 30
        d = s - c
        assert d.matmul_flops == 20.0 and d.conv_flops == 8.0

    def test_counts_do_not_nest(self):
        with pytest.raises(RuntimeError, match="nest"):
            count_costs(lambda: count_costs(torch.zeros, 2))


class TestUtilizationFields:
    def test_field_derivations(self):
        c = Cost(matmul_flops=989.4e9, conv_flops=0.0, vpu_elems=1e9,
                 bytes_lower=3.35e9, bytes_upper=2e10)
        f = utilization_fields(c, 1000.0, prefix="x_")  # 1 second
        assert abs(f["x_mfu"] - 989.4e9 / 989.4e12) < 1e-12
        assert abs(f["x_hbm_util_lower"] - 3.35e9 / 3.35e12) < 1e-12
        assert f["x_gflops"] == 989.4
        assert f["x_vpu_gelems_per_s"] == 1.0

    def test_zero_time_is_safe(self):
        assert utilization_fields(Cost(), 0.0) == {}

    def test_peaks_are_the_h100s(self):
        """NVIDIA H100 SXM5, dense BF16 tensor cores and HBM3: the
        defaults of utilization_fields."""
        assert H100_SXM_PEAK_BF16_FLOPS == 989.4e12
        assert H100_SXM_HBM_BYTES_PER_S == 3.35e12
        c = Cost(matmul_flops=2 * 989.4e9, bytes_lower=3.35e9)
        f = utilization_fields(c, 1000.0)
        assert f["mfu"] == 0.002 and f["hbm_util_lower"] == 0.001


# ---------------------------------------------------------------- models

def _tiny():
    """comic_tpu's tiny flagship, its params as numpy, and the port's
    spec and the same params through params.py."""
    from __graft_entry__ import _flagship
    from comic_tpu_torch.entry import flagship

    config, jspec, jparams = _flagship(tiny=True)
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    _, tspec = flagship(tiny=True)
    return config, jspec, jp, tspec, bridge.from_jax_tree(jp, "cpu")


def _serve_fns(jspec, tspec):
    """The tiny serve of test_roofline.py (beam 2, never ending) in both
    packages: comic_tpu's early-exit while_loop, the port's fixed loop."""
    from comic_tpu.decoding import beam_search as jbeam
    from comic_tpu_torch.decoding.search import beam_search as tbeam

    jspec = jspec._replace(decoder=jspec.decoder._replace(end_id=-1))
    tspec = tspec._replace(decoder=tspec.decoder._replace(end_id=-1))

    def jserve(params, images):
        top, _ = jbeam(params, jspec, images, beam_size=2, max_steps=6,
                       length_penalty=0.0, collect_alignments=False,
                       early_exit=True)
        return top.ids

    @torch.inference_mode()
    def tserve(params, images, steps):
        top, _ = tbeam(params, tspec, images, beam_size=2, max_steps=steps,
                       length_penalty=0.0, collect_alignments=False,
                       early_exit=False)
        return top.ids

    return jserve, tserve


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def serve_images():
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)
    return images, _t(images).permute(0, 3, 1, 2).contiguous()


class TestModelTrace:
    """The counter runs the real serving program (tiny flagship)."""

    def test_tiny_serve_decomposes(self, tiny, serve_images):
        _, jspec, _, tspec, params = tiny
        _, tserve = _serve_fns(jspec, tspec)
        images = serve_images[1]
        c6, c1, c2 = (count_costs(tserve, params, images, n)
                      for n in (6, 1, 2))
        assert c6.conv_flops == c1.conv_flops > 0  # encoder outside loop
        step = c2 - c1
        assert step.matmul_flops > 0 and step.vpu_elems > 0
        # 6 steps minus 1 step == 5x the one-step increment
        assert (c6 - c1).matmul_flops == 5 * step.matmul_flops
        assert c6.by_primitive["grouped_add_ln_attention"] == \
            6 * c1.by_primitive["grouped_add_ln_attention"]


# ------------------------------------------------- against comic_tpu's count

def _gemm(xp):
    return lambda a, b: a @ b


def _batched(xp):
    return jnp.matmul if xp == "jax" else torch.matmul


def _conv(xp, groups=1):
    if xp == "jax":
        return lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return lambda x, w: F.conv2d(x, w, padding="same", groups=groups)


# name: (maker of the function, numpy inputs in comic_tpu's layout,
# the port's permutations)
CASES = {
    "gemm": (_gemm, [(64, 32), (32, 16)], [None, None]),
    "batched": (_batched, [(4, 8, 6), (4, 6, 5)], [None, None]),
    "conv": (_conv, [(2, 8, 8, 3), (3, 3, 3, 7)],
             [(0, 3, 1, 2), (3, 2, 0, 1)]),
    "grouped_conv": (functools.partial(_conv, groups=8),
                     [(1, 8, 8, 8), (3, 3, 1, 8)],
                     [(0, 3, 1, 2), (3, 2, 0, 1)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gemm_and_conv_counts_equal_comic_tpu(case):
    build, shapes, perms = CASES[case]
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    want = jroof.count_costs(build("jax"), *xs)
    ts = [_t(x) if p is None else _t(x).permute(*p).contiguous()
          for x, p in zip(xs, perms)]
    got = count_costs(build("torch"), *ts)
    assert got.matmul_flops == want.matmul_flops
    assert got.conv_flops == want.conv_flops
    assert got.mxu_flops > 0
    # program I/O: both count the same inputs and output
    assert got.bytes_lower == want.bytes_lower


@pytest.mark.parametrize("legacy", [False, True])
def test_tiny_encoder_counts_equal_comic_tpu(legacy):
    """Inception-V1 at 64x64 (and the legacy head's LN and dense)."""
    from comic_tpu.models import inception_v1 as jinc

    params = {"cnn": jax.tree_util.tree_map(
        np.asarray, jinc.init_params(jax.random.PRNGKey(0)))}
    rng = np.random.default_rng(1)
    if legacy:
        params["LN_tanh"] = {
            "scale": rng.normal(1, 0.1, 1024).astype(np.float32),
            "bias": rng.normal(0, 0.1, 1024).astype(np.float32)}
        params["im_embed"] = {
            "kernel": rng.normal(0, 0.05, (1024, 1024)).astype(np.float32)}
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jroof.count_costs(
        lambda p, x: jenc.encode_images(p, x, "inception_v1", legacy=legacy),
        params, images)
    got = count_costs(
        lambda p, x: tenc.encode_images(p, x, "inception_v1", legacy=legacy),
        bridge.from_jax_tree(params, "cpu"),
        _t(images).permute(0, 3, 1, 2).contiguous())
    assert got.conv_flops == want.conv_flops > 0
    assert got.matmul_flops == want.matmul_flops
    assert (got.matmul_flops > 0) == legacy


def _nbytes(tree):
    return sum(np.asarray(x).nbytes
               for x in jax.tree_util.tree_leaves(tree))


def test_entry_forward_counts_equal_comic_tpu(tiny):
    """entry(tiny=True)'s XE forward on comic_tpu's params against
    comic_tpu's xe_forward (entry()'s forward) on the same inputs."""
    from comic_tpu.models.captioner import xe_forward
    from comic_tpu_torch.entry import entry

    _, jspec, jp, _, _ = tiny
    fn, (params, images, captions) = entry("cpu", tiny=True, params=jp)

    def jfn(p, im, caps):
        loss, aux = xe_forward(p, jspec, im, caps, training=False)
        return loss, aux["logits"]

    jimages = np.zeros((8, 64, 64, 3), np.float32)
    jcaps = captions.numpy()
    want = jroof.count_costs(jfn, jp, jimages, jcaps)
    got = count_costs(fn, params, images, captions)
    assert got.matmul_flops == want.matmul_flops > 0
    assert got.conv_flops == want.conv_flops > 0
    # the port's bytes_lower is the program's I/O alone: comic_tpu's I/O
    # term, without the decoder scan's operands once a step
    loss, logits = jfn(jp, jimages, jcaps)
    io = _nbytes((jp, jimages, jcaps)) + _nbytes((loss, logits))
    assert got.bytes_lower == io < want.bytes_lower


def test_tiny_serve_counts_equal_comic_tpu(tiny, serve_images):
    """6 fixed beam steps against comic_tpu's while_loop at
    while_trip_count=6: every step's GEMMs inside the loop on both
    sides, and the same captions."""
    _, jspec, jp, tspec, params = tiny
    jserve, tserve = _serve_fns(jspec, tspec)
    jimages, timages = serve_images
    want = jroof.count_costs(jserve, jp, jimages, while_trip_count=6.0)
    got = count_costs(tserve, params, timages, 6)
    assert got.matmul_flops == want.matmul_flops > 0
    assert got.conv_flops == want.conv_flops > 0
    np.testing.assert_array_equal(tserve(params, timages, 6).numpy(),
                                  np.asarray(jserve(jp, jimages)))


# (B, K, L, U, H); K2 takes B * K rows, each with its own keys
ATTN_SHAPES = [(2, 3, 7, 32, 2), (3, 1, 49, 64, 4)]


def _attention_inputs(b, k, l, u, h, keys_dtype, grouped):
    rng = np.random.default_rng(b * 100 + l)
    rows = b if grouped else b * k
    keys = rng.normal(size=(rows, l, u)).astype(np.float32)
    query = rng.normal(size=(b, k, u) if grouped else (rows, u))
    p = {"query_layer": {"kernel": rng.normal(size=(u, u)) * 0.1},
         "v": rng.normal(size=u) * 0.2,
         "ln": {"scale": 1 + 0.3 * rng.normal(size=u),
                "bias": 0.3 * rng.normal(size=u)},
         "softmax_temperature": np.float32(5.0)}
    p = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), p)
    return p, query.astype(np.float32), keys.astype(keys_dtype)


@pytest.mark.parametrize("keys_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_cost_equals_comic_tpu_walk(shape, grouped, keys_dtype):
    """add_ln_attention_cost (what K1/K2 report) == comic_tpu's count of
    attend_grouped / attend minus that of its query projection: matmul
    flops, elementwise work and per-op bytes, exactly."""
    b, k, l, u, h = shape
    dtype = jnp.bfloat16 if keys_dtype == "bfloat16" else jnp.float32
    p, query, keys = _attention_inputs(b, k, l, u, h, np.float32, grouped)
    keys = jnp.asarray(keys, dtype)
    k32 = keys.astype(jnp.float32)
    memory = jatt.AttentionMemory(keys, jsplit(keys, h), k32.mean(-1),
                                  jnp.square(k32).mean(-1))
    cfg = jatt.AttentionConfig(num_units=u, num_heads=h, memory_channels=u)
    step = jatt.attend_grouped if grouped else jatt.attend
    whole = jroof.count_costs(lambda p, q, m: step(p, cfg, q, m),
                              p, query, memory)
    proj = jroof.count_costs(lambda p, q: jdense(p["query_layer"], q),
                             p, query)
    want = whole - proj
    torch_dtype = getattr(torch, keys_dtype)
    got = add_ln_attention_cost(torch.empty(query.shape),
                                torch.empty(keys.shape, dtype=torch_dtype), h)
    assert got.matmul_flops == want.matmul_flops == 4 * query.size * l
    assert got.vpu_elems == want.vpu_elems
    # comic_tpu's attend_grouped also traces `keys = memory.keys[:, None]`
    # (comic_tpu/models/attention.py:296), which only the path without key
    # moments reads; jax keeps that dead broadcast in the jaxpr, and its
    # operand and result (2 * B * L * U of the keys' dtype) in the walk
    dead = 2 * keys.size * keys.dtype.itemsize if grouped else 0
    assert got.bytes_upper == want.bytes_upper - dead
    assert got.conv_flops == 0


def _kernel_call(grouped, keys_dtype):
    b, k, l, u, h = ATTN_SHAPES[0]
    p, query, keys = _attention_inputs(b, k, l, u, h, np.float32, grouped)
    keys = _t(keys).to(keys_dtype)
    k32 = keys.float()
    vecs = [_t(p["v"]), _t(p["ln"]["scale"]), _t(p["ln"]["bias"]),
            torch.tensor(5.0)]
    if grouped:
        return (k1.grouped_add_ln_attention,
                (_t(query), keys, k32.mean(-1), k32.square().mean(-1),
                 *vecs), h)
    return k2.fused_add_ln_attention, (_t(query), keys, *vecs), h


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_wrapper_call_counted_once(grouped, keys_dtype):
    """On the CPU the wrapper runs the plain version; the count is the
    analytic cost alone, not that plus the plain version's operations."""
    fn, args, h = _kernel_call(grouped, keys_dtype)
    got = count_costs(fn, *args, num_heads=h)
    want = add_ln_attention_cost(args[0], args[1], h)
    assert got.matmul_flops == want.matmul_flops
    assert got.vpu_elems == want.vpu_elems
    assert got.bytes_upper == want.bytes_upper
    assert got.by_primitive == want.by_primitive
    ctx, align = fn(*args, num_heads=h)
    assert got.bytes_lower == sum(
        t.numel() * t.element_size() for t in (*args, ctx, align))


@pytest.mark.parametrize("grouped", [True, False])
def test_attention_step_counts_the_kernel_cost_on_the_cpu(grouped):
    """attend_grouped / attend in the kernels' domain take their torch ops
    on the CPU; a count takes them as the kernel's cost, as on the card:
    the query projection plus add_ln_attention_cost."""
    from comic_tpu_torch.models import attention as tatt

    b, k, l, u, h = ATTN_SHAPES[0]
    p, query, keys = _attention_inputs(b, k, l, u, h, np.float32, grouped)
    tp = bridge.from_jax_tree(p, "cpu")
    cfg = tatt.AttentionConfig(num_units=u, num_heads=h, memory_channels=u)
    keys = _t(keys)
    memory = tatt.AttentionMemory(
        keys, keys.reshape(keys.shape[0], l, h, u // h).transpose(1, 2),
        keys.mean(-1), keys.square().mean(-1))
    step = tatt.attend_grouped if grouped else tatt.attend
    got = count_costs(lambda q: step(tp, cfg, q, memory), _t(query))
    want = add_ln_attention_cost(_t(query), keys, h)
    proj = 2 * query.size * u
    assert got.matmul_flops == proj + want.matmul_flops
    name = next(iter(want.by_primitive))
    assert got.by_primitive[name] == want.by_primitive[name]
    # under autograd the step is no kernel's work: its ops are counted
    tp["query_layer"]["kernel"].requires_grad_()
    got = count_costs(lambda q: step(tp, cfg, q, memory), _t(query))
    assert name not in got.by_primitive
    assert got.matmul_flops == proj + want.matmul_flops
