"""comic_tpu_torch.bench and its tools against the root bench.py, on the CPU
at the tiny flagship size (float32, weights carried from comic_tpu's tree).

The serving programs are held id for id against root bench.py's jitted
``_make_serve``: the worst case (unreachable EOS, every step runs) and the
floor (EOS-biased, every beam ends at once). Every leg runs once through
``main``, whose JSON line must hold exactly root bench.py's keys less the
TPU vector-unit fields, plus ``device``, ``tf32`` and ``launches``.
"""

import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as jbench  # noqa: E402  (root bench.py, comic_tpu's)
from __graft_entry__ import _flagship  # noqa: E402
from comic_tpu.configuration import Config as JConfig  # noqa: E402
from comic_tpu.models.captioner import \
    max_decode_steps as jmax_decode_steps  # noqa: E402
from comic_tpu_torch import bench as tbench  # noqa: E402
from comic_tpu_torch import inference as tinf  # noqa: E402
from comic_tpu_torch.decoding import search as tsearch  # noqa: E402
from comic_tpu_torch.entry import flagship  # noqa: E402
from comic_tpu_torch.models import attention as tatt  # noqa: E402
from comic_tpu_torch.models.captioner import max_decode_steps  # noqa: E402
from comic_tpu_torch.params import from_jax_tree  # noqa: E402
from comic_tpu_torch.tokenization import RadixCodec  # noqa: E402
from comic_tpu_torch.tools import (batch_sweep, beam_sweep,  # noqa: E402
                                   loader_bench, serve_check)

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 8

# every leg at the tiny size, one timed call each
TINY = {
    "serving": dict(batches=(2, 3), iters=1, warmup=1, rounds=1),
    "serving_floor": dict(batch=2, iters=1, warmup=1, rounds=1),
    "roofline_serving": dict(batch=2),
    "serving_realistic": dict(batch=2, iters=1, warmup=1, rounds=1),
    "xe_step": dict(batch=2, iters=1, k=2, iters_k=1, warmup=1, rounds=1),
    "xe_best": dict(batches=(2, 3), k=2, iters=1, warmup=1, rounds=1),
    "scst": dict(batch=2, iters=1, warmup=1, rounds=1),
    "scst_loop": dict(batch=2, steps=2, warmup=1, runs=1, n_batches=2),
    "host_loader": dict(images=8, min_s=0.05),
}

# root bench.py's JSON keys (bench.py:811-844), less nothing at the top
# level, plus the port's three
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_note", "best_batch",
    "decode_steps", "xe_step_ms_b32", "xe_step_ms_b32_scan8",
    "scst_rollout_ms_b10", "scst_train_ms_b10", "scst_loop_eps_overlap",
    "scst_loop_eps_strict", "serve_floor_ms_b128_earlyexit",
    "serve_captions_per_s_realistic", "serve_ms_b128_realistic40",
    "xe_best_examples_per_s", "xe_best_batch", "xe_examples_per_s_by_batch",
    "host_loader_images_per_s", "host_loader_images_per_s_per_core",
    "host_loader_cores_to_sustain_headline",
    "host_loader_packed_h5_images_per_s", "host_cores",
    "serve_ms_b25_refpoint", "roofline"}
PORT_KEYS = {"device", "tf32", "launches"}
_UTIL = ("gflops", "mfu", "vpu_gelems_per_s", "hbm_gb_lower",
         "hbm_gb_upper", "hbm_util_lower")
# root bench.py's roofline keys less bench_vpu_peak's (vpu_peak_measured_
# gelems, vpu_tanh_chain_us_per_step, attn_score_chain_us_per_step,
# attn_score_chain_gelems_per_s) and the two *_frac_of_peak
ROOFLINE_KEYS = {f"{p}{f}" for p in (
    "serve_b128_", "decode_step_", "encoder_prep_b128_", "xe_step_b32_",
    "scst_rollout_b10_", "scst_train_b10_") for f in _UTIL} | {
    "decode_step_ms_est", "decode_step_matmul_gflops",
    "decode_step_vpu_melems", "decode_step_budget_melems"}
LEGS = {"serving", "serving_b2", "serving_b3", "serving_floor",
        "roofline_serving", "serving_realistic", "xe_step", "xe_best",
        "scst", "scst_loop"}


@pytest.fixture(scope="module")
def tiny():
    """Both packages' tiny flagship on comic_tpu's init tree, and a batch
    of 2 images of 80x80 (cropped to 64)."""
    jconfig, jspec, jparams = _flagship(tiny=True)
    config, spec = flagship(tiny=True)
    params = from_jax_tree(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    images = np.random.default_rng(0).integers(0, 256, (2, 80, 80, 3),
                                               dtype=np.uint8)
    return jconfig, jspec, jparams, config, spec, params, images


@pytest.fixture
def step_count(monkeypatch):
    """Counts the beam search's decoder steps."""
    calls = []
    real = tsearch.step_grouped

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tsearch, "step_grouped", counted)
    return calls


def test_real_vocab_is_bench_real_vocab():
    vocab, jvocab = tbench.real_vocab(), jbench.real_vocab()
    assert vocab.wtoi == jvocab.wtoi
    assert len(vocab) == tbench.COCO_VOCAB_WORDS + 4
    assert RadixCodec(len(vocab), 256).word_len == 2
    config, _ = flagship()  # COMIC-256
    kw = dict(token_type="radix", radix_base=256, attn_num_heads=8,
              cnn_fm_projection="tied", rnn_size=512, rnn_word_size=256)
    assert max_decode_steps(config, vocab) == 60
    assert jmax_decode_steps(JConfig(**kw), jvocab) == 60


def test_worst_case_serve_ids_equal_bench(tiny, step_count):
    jconfig, jspec, jparams, config, spec, params, images = tiny
    jspec = jspec._replace(decoder=jspec.decoder._replace(end_id=-1))
    want = np.asarray(jax.jit(jbench._make_serve(jconfig, jspec, STEPS))(
        jparams, jnp.asarray(images)))
    serve = tbench._make_serve(config, tbench.worst_case(spec), STEPS, CPU)
    got = serve(params, torch.from_numpy(images)).numpy()
    assert got.shape == (2, STEPS)
    np.testing.assert_array_equal(got, want)
    assert len(step_count) == STEPS  # early exit on, and every step ran
    assert not (got == spec.decoder.end_id).any()


def test_floor_serve_ends_every_beam_at_once(tiny, step_count):
    jconfig, jspec, jparams, config, spec, params, images = tiny
    end = jspec.decoder.end_id
    assert end == spec.decoder.end_id
    p2 = jax.tree_util.tree_map(jnp.array, jparams)
    bias = p2["decoder"]["output_projection"]["bias"]
    p2["decoder"]["output_projection"]["bias"] = bias.at[end].add(8.0)
    want = np.asarray(jax.jit(jbench._make_serve(
        jconfig, jspec, STEPS, lpen=0.0))(p2, jnp.asarray(images)))
    serve = tbench._make_serve(config, spec, STEPS, CPU, lpen=0.0)
    got = serve(tbench.eos_biased(params, end),
                torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    # the top beam is EOS from the first step on, and the loop stopped at
    # its first early-exit check
    assert (got == end).all()
    assert len(step_count) == tsearch.EXIT_CHECK_EVERY < STEPS
    # the unbiased weights do not end at once: the bias made the floor
    assert not (serve(params, torch.from_numpy(images)).numpy()
                == end).all()


def test_eos_biased_shares_every_other_leaf(tiny):
    *_, params, _ = tiny
    biased = tbench.eos_biased(params, 5, 8.0)
    bias = params["decoder"]["output_projection"]["bias"]
    assert torch.equal(biased["decoder"]["output_projection"]["bias"] - bias,
                       8.0 * (torch.arange(bias.numel()) == 5).float())
    assert biased["encoder"] is params["encoder"]
    assert (biased["decoder"]["attention"]
            is params["decoder"]["attention"])


@pytest.mark.parametrize("warmup,rounds,iters", [(2, 2, 5), (0, 1, 1),
                                                 (1, 3, 2)])
def test_pipelined_ms_calls_warmup_plus_rounds_times_iters(warmup, rounds,
                                                           iters):
    calls = []
    ms = tbench._pipelined_ms(lambda x: calls.append(x), (7,), iters, CPU,
                              warmup=warmup, rounds=rounds)
    assert calls == [7] * (warmup + rounds * iters)
    assert 0 <= ms < math.inf


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def test_every_leg_runs_and_main_prints_bench_keys(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    returned = tbench.main(["--device", "cpu"], tiny=True, sizes=TINY)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(printed)
    assert printed == json.dumps(returned)  # one line, main's own
    assert set(line) == BENCH_KEYS | PORT_KEYS
    assert set(line["roofline"]) == ROOFLINE_KEYS
    assert set(line["launches"]) == LEGS
    # no kernel launches on the CPU: the plain versions ran
    assert all(n == 0 for leg in line["launches"].values()
               for n in leg.values())
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["decode_steps"] == 60 and line["best_batch"] in (2, 3)
    assert line["serve_ms_b25_refpoint"] is None  # no batch of 25 here
    assert set(line["xe_examples_per_s_by_batch"]) == {"2", "3"}
    numbers = list(_numbers(line))
    assert len(numbers) > 60 and all(math.isfinite(v) for v in numbers)
    for key in ("value", "xe_step_ms_b32", "xe_step_ms_b32_scan8",
                "scst_rollout_ms_b10", "scst_train_ms_b10",
                "scst_loop_eps_overlap", "scst_loop_eps_strict",
                "serve_floor_ms_b128_earlyexit",
                "serve_ms_b128_realistic40", "xe_best_examples_per_s"):
        assert line[key] > 0, key
    with open(tmp_path / "infer_speed.txt") as f:
        assert f.read().endswith(
            f"(batch {line['best_batch']}, beam 3, max_steps 60)\n")


def test_attn_only_runs_the_attention_steps_times(tiny, monkeypatch):
    *_, config, spec, params, images = tiny
    calls = []
    real = tatt._attend_grouped_ops

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tatt, "_attend_grouped_ops", counted)
    with torch.inference_mode():
        _, memory = tsearch._prepare_memory(params, spec,
                                            torch.zeros(2, 3, 64, 64))
    q0 = torch.randn(2, 3, spec.decoder.rnn_size,
                     generator=torch.Generator().manual_seed(0))
    out = batch_sweep.attn_only(params["decoder"]["attention"],
                                spec.decoder.attention, q0, memory, 5,
                                spec.compute_dtype)
    assert len(calls) == 5
    assert out.shape == q0.shape and torch.isfinite(out).all()


def test_batch_sweep_rows_at_tiny_size(tiny):
    *_, config, spec, params, _ = tiny
    vocab = tbench.flagship_model(CPU, tiny=True)[3]
    rows = list(batch_sweep.sweep(config, spec, params, vocab, CPU, [2],
                                  iters=1, warmup=0, rounds=1))
    (row,) = rows
    assert row["batch"] == 2 and row["rows"] == 6 and row["steps"] == 60
    assert row["serve_ms"] > 0 and row["decode_ms"] > 0
    assert row["attn_ms"] > 0
    assert row["k1_launches_per_call"] == {"serve": 0, "decode": 0,
                                           "attn": 0}


def test_beam_sweep_beam_one_takes_the_greedy_path(tiny, monkeypatch):
    *_, config, spec, params, _ = tiny
    vocab = tbench.flagship_model(CPU, tiny=True)[3]
    taken = []
    for name in ("greedy_or_sample", "beam_search"):
        real = getattr(tinf, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            taken.append((_name, kwargs.get("beam_size")))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tinf, name, counted)
    rows = list(beam_sweep.sweep(config, spec, params, vocab, CPU, [1, 2],
                                 batch=2, iters=1, warmup=0, rounds=1))
    assert [r["beam"] for r in rows] == [1, 2]
    assert [r["rows"] for r in rows] == [2, 4]
    assert taken == [("greedy_or_sample", None), ("beam_search", 2)]


def test_serve_check_at_tiny_size(tiny, step_count):
    *_, config, spec, params, _ = tiny
    vocab = tbench.flagship_model(CPU, tiny=True)[3]
    ms = serve_check.serve_ms(config, spec, params, vocab, CPU, 2, iters=1,
                              warmup=0, rounds=1)
    assert ms > 0
    assert len(step_count) == 60  # the forced 60 steps


def test_loader_names_a_missing_library(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "PIL" else real(name, *a)))
    out = loader_bench.measure(100.0, n_images=4, min_s=0.01)
    assert out["host_cores"] == (os.cpu_count() or 1)
    for key in ("file_loader_square_w8", "file_loader_images_per_s_per_core",
                "cores_to_sustain_target", "packed_h5_images_per_s"):
        assert out[key] == "PIL not installed"


def test_loader_bench_measures_the_file_and_packed_sources():
    out = loader_bench.measure(100.0, n_images=6, min_s=0.02)
    for w in loader_bench.WORKERS:
        assert out[f"file_loader_square_w{w}"] > 0
    assert out["packed_h5_images_per_s"] > 0
    assert out["cores_to_sustain_target"] == round(
        100.0 / out["file_loader_square_w1"], 1)
