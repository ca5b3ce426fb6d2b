"""comic_tpu_torch.tools.parity_gate, the port's reference-parity gate,
rehearsed as tests/test_parity_gate.py rehearses tools/parity_gate.py: the
gate must PASS on a reference-style experiment directory (config.pkl and a
TF model_compact-50 written with tf.compat.v1) whose checkpoint reproduces
the annotated captions, FAIL on a wrong-weights directory scored against
the same annotations and target, and refuse to score through the Python
PTB fallback unless it is allowed.

The same self-consistency trick: the port decodes the right weights'
captions first (on the CPU) and the annotation JSON is written from them,
so the right weights reproduce their own references. Both gates then run,
each on its own copy of each directory (a sweep skips checkpoints whose
caption JSON exists), in float32: their verdict JSONs must be equal key
for key, with CIDEr equal to 1e-12, and their exit codes equal, on the
PASS leg and on the FAIL leg.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import test_parity_gate as jgate_test
from comic_tpu_torch.data.synthetic import make_synthetic_dataset
from comic_tpu_torch.evaluation.coco_eval import evaluate_captions
from comic_tpu_torch.inference import sweep_checkpoints
from comic_tpu_torch.tools import parity_gate

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools import parity_gate as jparity_gate  # noqa: E402

torch.set_num_threads(1)

CKPT = "model_compact-50"


def _argv(exp_dir, root, ann_file, target):
    return ["--experiment_dir", exp_dir, "--dataset_dir", root,
            "--annotations_file", ann_file, "--target_cider", repr(target),
            "--infer_set", "test", "--batch_size_infer", "2",
            "--infer_beam_size", "2", "--infer_max_length", "8"]


def _gate(main, argv):
    """Run a gate's ``main`` -> (exit code, its verdict JSON, its last
    line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().splitlines()
    return rc, json.loads(lines[-2]), lines[-1]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The dataset, the right and wrong weights' directories (a copy of
    each for each gate), the annotations written from the right weights'
    captions as the port decodes them, and the CIDEr those captions score
    (the target)."""
    tmp = tmp_path_factory.mktemp("torch_pgate")
    root, _ = make_synthetic_dataset(
        str(tmp / "d"), num_train=4, num_valid=2, num_test=6,
        captions_per_image=1, distinct_images=True)
    dirs = {}
    for name, seed in (("right", 3), ("wrong", 99)):
        config = jgate_test._make_reference_dir(tmp, root, name, seed)
        for gate in ("port", "jax"):
            dirs[name, gate] = str(tmp / f"{name}_{gate}")
            shutil.copytree(config.log_path, dirs[name, gate])
        if name == "right":
            right = config
    sweep_checkpoints(right, get_metric_score=False, device="cpu")
    caps = jgate_test._read_captions(right.log_path)
    assert any(c.strip() for c in caps.values()), caps
    # the gate is informative only where the captions differ across images
    assert len(set(caps.values())) >= 3, caps
    ann_file = str(tmp / "annotations_ref.json")
    with open(ann_file, "w") as f:
        json.dump({"annotations": [
            {"image_id": k, "caption": c or "a", "id": i}
            for i, (k, c) in enumerate(caps.items())]}, f)
    infer_dir = [d for d in os.listdir(right.log_path)
                 if d.startswith("infer_")][0]
    target, _ = evaluate_captions(ann_file, os.path.join(
        right.log_path, infer_dir, f"captions___{CKPT}.json"))
    assert target["CIDEr"] > 1.0, target  # a self-match scores high
    return dict(root=root, dirs=dirs, right=right.log_path, ann=ann_file,
                target=float(target["CIDEr"]), caps=caps)


@pytest.fixture(scope="module")
def verdicts(env):
    """Both gates on their copies of both directories, with the Python PTB
    fallback allowed -> {(leg, gate): (rc, verdict, last line)}."""
    mains = {"port": lambda a: parity_gate.main(a + ["--device", "cpu"]),
             "jax": jparity_gate.main}
    return {(leg, gate): _gate(mains[gate], _argv(
        env["dirs"][leg, gate], env["root"], env["ann"], env["target"])
        + ["--allow_ptb_fallback"])
        for leg in ("right", "wrong") for gate in ("port", "jax")}


def test_gate_passes_on_right_weights(env, verdicts):
    rc, verdict, line = verdicts["right", "port"]
    assert rc == 0 and line.startswith("PARITY PASS: ")
    assert verdict["passed"] is True
    assert verdict["best_checkpoint"] == CKPT
    assert verdict["best_cider"] >= env["target"] * 0.995
    assert verdict["tokenizer"] == "python_fallback_allowed"
    # the gate decoded the checkpoint itself: the fixture's captions
    assert jgate_test._read_captions(env["dirs"]["right", "port"]) \
        == env["caps"]


def test_gate_fails_on_wrong_weights(env, verdicts):
    rc, verdict, line = verdicts["wrong", "port"]
    assert rc == 1 and line.startswith("PARITY FAIL: ")
    assert verdict["passed"] is False
    assert verdict["best_cider"] < env["target"] * 0.995
    # the FAIL means something only where the wrong weights decoded
    # other captions
    assert jgate_test._read_captions(env["dirs"]["wrong", "port"]) \
        != env["caps"]


def test_gate_refuses_fallback_tokenizer_by_default(env):
    with pytest.raises(RuntimeError, match="PTB jar required"):
        parity_gate.main(_argv(env["right"], env["root"], env["ann"],
                               env["target"]) + ["--device", "cpu"])


@pytest.mark.parametrize("leg", ["right", "wrong"])
def test_verdict_equals_comic_tpus_gate(verdicts, leg):
    """tools/parity_gate.py and the port's gate on copies of one directory:
    the same exit code, the same verdict JSON key for key (CIDEr to
    1e-12), the same last line."""
    rc, got, line = verdicts[leg, "port"]
    want_rc, want, want_line = verdicts[leg, "jax"]
    assert rc == want_rc and list(got) == list(want)
    for key, value in want.items():
        if key == "per_checkpoint_cider":
            assert list(got[key]) == list(value)
            np.testing.assert_allclose(list(got[key].values()),
                                       list(value.values()), rtol=1e-12)
        elif key in ("best_cider", "threshold"):
            np.testing.assert_allclose(got[key], value, rtol=1e-12)
        else:
            assert got[key] == value, key
    assert line == want_line


def test_gate_has_comic_tpus_flags():
    """The same flags and defaults as tools/parity_gate.py, plus --device
    (the card unless it names the CPU)."""
    got = {a.dest: a.default for a in parity_gate.create_parser()._actions}
    want = {a.dest: a.default for a in jparity_gate.create_parser()._actions}
    assert got.pop("device") is None
    assert got == want
