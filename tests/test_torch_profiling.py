"""comic_tpu_torch's StepTracer (utils/profiling.py) and its wiring into
the XE driver, on the CPU: the window of comic_tpu's tracer (calls, not
step values; [start, start+count); close() ends it; no-op without a
directory), one TensorBoard trace file with one ProfilerStep span per
traced iteration, a profiler that fails raising (comic_tpu's stays
silent), and tracing that leaves losses and parameters bit for bit."""

import glob
import json
import os

import pytest
import torch
from flax import serialization

from comic_tpu_torch.configuration import Config
from comic_tpu_torch.data.synthetic import make_synthetic_dataset
from comic_tpu_torch.training import xe as txe
from comic_tpu_torch.utils.profiling import StepTracer

torch.set_num_threads(1)


def _events(log_dir):
    """The events of the one trace file in ``log_dir``."""
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _trace(log_dir):
    """-> (ProfilerStep span names in order, names of every span) of the
    one trace file in ``log_dir``."""
    names = [e.get("name", "") for e in _events(log_dir)
             if e.get("cat") == "user_annotation"]
    return [n for n in names if n.startswith("ProfilerStep#")], set(names)


def _loop(tracer, iterations, stride=1):
    a = torch.randn(32, 32)
    for i in range(iterations):
        with torch.profiler.record_function(f"iter{i}"):
            a = torch.tanh(a @ a)
        tracer.step(i * stride)
    tracer.close()


@pytest.mark.parametrize("stride", [1, 4])
def test_window_counts_calls(tmp_path, stride):
    """start=2, count=3: the trace opens after the third call and holds the
    next three iterations, whatever step values are passed."""
    tracer = StepTracer(str(tmp_path), start=2, count=3, device="cpu")
    _loop(tracer, 10, stride)
    steps, names = _trace(str(tmp_path))
    assert steps == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    assert {n for n in names if n.startswith("iter")} == {
        "iter3", "iter4", "iter5"}


def test_close_ends_an_open_window(tmp_path):
    """The window [1, 6) cut by close() after call 3: the spans of calls 1
    to 3, the last one open until close()."""
    tracer = StepTracer(str(tmp_path), start=1, count=5, device="cpu")
    _loop(tracer, 4)
    steps, names = _trace(str(tmp_path))
    assert steps == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    assert {n for n in names if n.startswith("iter")} == {"iter2", "iter3"}


@pytest.mark.parametrize("log_dir", [None, ""])
def test_no_op_without_a_directory(tmp_path, monkeypatch, log_dir):
    """No profiler is made and no card is needed (device None)."""
    def refuse(*a, **k):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    tracer = StepTracer(log_dir, start=0, count=3)
    for i in range(5):
        tracer.step(i)
    tracer.close()
    assert os.listdir(tmp_path) == []


def test_close_is_idempotent(tmp_path):
    tracer = StepTracer(str(tmp_path), start=0, count=10, device="cpu")
    tracer.close()  # before any window
    tracer.step(0)
    tracer.step(1)
    tracer.close()
    tracer.close()
    steps, _ = _trace(str(tmp_path))
    assert steps == ["ProfilerStep#0", "ProfilerStep#1"]


def test_profiler_that_fails_to_start_raises(tmp_path, monkeypatch):
    def fail(self):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler.profile, "start", fail)
    tracer = StepTracer(str(tmp_path), start=1, count=3, device="cpu")
    tracer.step(0)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        tracer.step(1)
    tracer.close()


def test_profiler_that_fails_to_stop_raises(tmp_path, monkeypatch):
    def fail(self):
        raise RuntimeError("trace lost")

    tracer = StepTracer(str(tmp_path), start=0, count=3, device="cpu")
    tracer.step(0)
    monkeypatch.setattr(torch.profiler.profile, "stop", fail)
    with pytest.raises(RuntimeError, match="trace lost"):
        tracer.close()
    tracer.close()  # the window is gone: nothing left to stop


def test_card_trace_without_device_activity_raises(tmp_path):
    """A trace of the card that holds no CUDA event (CUPTI missing or
    busy) raises at close() instead of passing as an empty trace; here a
    tracer set for the card traces CPU work only."""
    tracer = StepTracer(str(tmp_path), start=0, count=3, device="cpu")
    tracer._cuda = True  # as StepTracer(..., device="cuda") sets it
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        _loop(tracer, 4)


STEPS = 14
DRIVER = dict(token_type="radix", radix_base=16, rnn_size=32,
              rnn_word_size=16, attn_num_heads=2, compute_dtype="float32",
              cnn_input_size=(64, 64), dataset_file_pattern="synth_{}",
              batch_size_train=4, batch_size_eval=4, max_epoch=500,
              lr_start=3e-3, lr_end=1e-4, cnn_input_augment=False,
              num_logs_per_epoch=STEPS, freeze_scopes="encoder/cnn",
              rand_seed=0)


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """train_fn for 14 steps (one epoch of 56 images, batch 4) with and
    without profile_dir -> (root, {"on": log dir, "off": log dir})."""
    root = tmp_path_factory.mktemp("profiling")
    data, _ = make_synthetic_dataset(str(root / "data"), num_train=56,
                                     num_valid=4, num_test=4,
                                     captions_per_image=1)
    runs = {}
    for name, profile_dir in (("off", None), ("on", str(root / "trace"))):
        runs[name] = str(root / name)
        txe.train_fn(Config(**DRIVER, dataset_dir=data, log_path=runs[name],
                            profile_dir=profile_dir),
                     max_steps_override=STEPS, device="cpu")
    return root, runs


def test_train_fn_writes_one_trace_of_three_steps(traced_runs):
    root, _ = traced_runs
    steps, _ = _trace(str(root / "trace"))
    assert steps == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    ops = {e["name"] for e in _events(str(root / "trace"))
           if e.get("cat") == "cpu_op"}
    # the traced steps' encoder forward and decoder backward
    assert {"aten::convolution", "autograd::engine::evaluate_function: "
            "MmBackward0"} <= ops


def _losses(log_path):
    """(step, losses) of every events.jsonl line with a loss."""
    keys = ("log_ppl", "total_loss", "map_loss", "reg", "eval_perplexity")
    with open(os.path.join(log_path, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return [(e["step"], [e.get(k) for k in keys]) for e in events
            if any(k in e for k in keys)]


def test_tracing_leaves_losses_and_parameters_bit_for_bit(traced_runs):
    _, runs = traced_runs
    on, off = _losses(runs["on"]), _losses(runs["off"])
    assert len(on) == STEPS + 1 and on == off  # 14 steps, 1 eval pass
    for prefix in ("model", "model_compact"):
        with open(os.path.join(runs["on"], f"{prefix}-{STEPS}.msgpack"),
                  "rb") as f:
            got = f.read()
        with open(os.path.join(runs["off"], f"{prefix}-{STEPS}.msgpack"),
                  "rb") as f:
            assert f.read() == got


def test_failing_tracer_still_closes_saver_and_writer(traced_runs,
                                                      monkeypatch):
    """12 steps leave the window [10, 13) open when the loop ends; the
    profiler then fails to stop in train_fn's cleanup, which raises after
    the checkpoint saver has written the last step's files and the writer
    every line."""
    root, _ = traced_runs

    def fail(self):
        raise RuntimeError("trace lost")

    monkeypatch.setattr(torch.profiler.profile, "stop", fail)
    log_path = str(root / "failing")
    with pytest.raises(RuntimeError, match="trace lost"):
        txe.train_fn(Config(**DRIVER, dataset_dir=str(root / "data"),
                            log_path=log_path,
                            profile_dir=str(root / "failing_trace")),
                     max_steps_override=12, device="cpu")
    losses = _losses(log_path)
    assert [step for step, _ in losses] == [*range(1, 13), 12]
    for name, top in (("model", "params"), ("model_compact", "decoder")):
        with open(os.path.join(log_path, f"{name}-12.msgpack"), "rb") as f:
            assert top in serialization.msgpack_restore(f.read())
