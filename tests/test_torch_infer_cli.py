"""Checkpoint evaluation, comic_tpu_torch against comic_tpu on the CPU:
sweep_checkpoints and evaluate_model from the same compact checkpoints
(written by comic_tpu) on the synthetic dataset at the tiny float32 config
of tests/test_torch_inference.py give byte-identical caption JSON and
score files; the toggles, explicit checkpoint lists, refusals and
clean-up of tests/test_inference.py; the infer CLI's flags, the config it
builds and its printed lines; and the refusal of a COMIC_COORDINATOR
launch by both of the port's CLIs."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from comic_tpu.cli import infer as jcli
from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.inference import sweep_checkpoints as jsweep
from comic_tpu.models import captioner as jcap
from comic_tpu.training.checkpoints import save_checkpoint
from comic_tpu_torch import inference as tinf
from comic_tpu_torch.cli import infer as tcli
from comic_tpu_torch.configuration import Config
from test_torch_native_ciderd import (  # noqa: F401 (fixtures)
    assert_both_native, ciderd_used, native_ciderd)

torch.set_num_threads(1)

# the tiny float32 config of tests/test_inference.py
CONFIG = dict(
    token_type="radix", radix_base=16, dataset_file_pattern="synth_{}",
    rnn_size=32, rnn_word_size=16, attn_num_heads=2,
    compute_dtype="float32", cnn_input_size=(64, 64), batch_size_infer=2,
    infer_max_length=10, infer_set="test")


def _dataset(tmp, style):
    """Synthetic dataset (4 test images, 2 references each) and two compact
    checkpoints written by comic_tpu: its init tree with BN statistics
    moved and the output projection spread, and the same with another
    bias, so that the two checkpoints caption differently."""
    root, vocab = make_synthetic_dataset(
        str(tmp / "d"), num_train=8, num_valid=4, num_test=4,
        captions_per_image=2, style=style)
    words = dict(wtoi=vocab.wtoi,
                 itow={str(k): w for k, w in vocab.itow.items()})
    spec = jcap.build_model_spec(JConfig(**CONFIG), vocab)
    tree = jax.tree_util.tree_map(
        np.array, jcap.init_params(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(0)

    def walk(d):
        for k, v in d.items():
            if k == "BatchNorm":
                n = v["beta"].shape[0]
                v["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
                v["moving_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            elif isinstance(v, dict):
                walk(v)

    walk(tree)
    proj = tree["decoder"]["output_projection"]
    proj["kernel"] *= 4
    ckpt_dir = str(tmp / "ckpts")
    for step, lead in ((1, 2.5), (2, 1.5)):
        # favour the digits 0 and 1, the leading digit of every word id of
        # this vocabulary, so that the captions hold words
        bias = np.zeros(CONFIG["radix_base"] + 2, np.float32)
        bias[[0, 1]] = lead
        bias[-1] = -1.5
        proj["bias"] = bias
        save_checkpoint(ckpt_dir, step, tree)
    ann = os.path.join(root, "captions", "annotations_test.json")
    return root, words, ckpt_dir, ann


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("coco"), "coco")


def _experiment(tmp, name, data, **overrides):
    """A fresh experiment dir holding the compact checkpoints -> (config
    class instance kwargs, log_path)."""
    root, words, ckpt_dir, _ = data
    log = str(tmp / name)
    os.makedirs(log)
    for f in os.listdir(ckpt_dir):
        if f.startswith("model_compact-"):
            shutil.copy(os.path.join(ckpt_dir, f), log)
    kw = dict(CONFIG, dataset_dir=root, log_path=log, **words)
    kw.update(overrides)
    return kw, log


def _outputs(save_dir):
    out = {}
    for name in sorted(os.listdir(save_dir)):
        if name == "infer_speed.txt":  # timings
            continue
        with open(os.path.join(save_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _sweep_both(tmp, data, **overrides):
    """Both packages' sweep_checkpoints over their own copy of the
    experiment -> {package: (results, files of the infer dir)}."""
    ann = data[3]
    out = {}
    for name, cfg, sweep in (
            ("jax", JConfig, jsweep),
            ("torch", Config,
             lambda c, a: tinf.sweep_checkpoints(c, a, device="cpu"))):
        kw, log = _experiment(tmp, name, data, **overrides)
        config = cfg(**kw)
        results = sweep(config, ann)
        out[name] = (results, _outputs(
            os.path.join(log, tinf.infer_dir_name(config))))
    return out


@pytest.mark.parametrize("style,beam", [("coco", 3), ("coco", 1),
                                        ("insta", 2)])
def test_sweep_is_byte_identical(tmp_path, coco, style, beam, ciderd_used):
    data = coco if style == "coco" else _dataset(tmp_path, style)
    out = _sweep_both(tmp_path, data, infer_beam_size=beam)
    (jres, jfiles), (tres, tfiles) = out["jax"], out["torch"]
    assert list(tres) == list(jres) == ["model_compact-1",
                                        "model_compact-2"]
    for name in jres:
        assert list(tres[name]) == list(jres[name])
        for m in jres[name]:
            assert tres[name][m] == pytest.approx(jres[name][m], abs=1e-12)
    assert sorted(tfiles) == sorted(jfiles) == [
        "captions___model_compact-1.json", "captions___model_compact-2.json",
        "metric_scores.csv", "metric_scores.txt",
        "metric_scores_detailed_0.json", "metric_scores_detailed_1.json"]
    assert tfiles == jfiles
    caps = [json.loads(tfiles[f"captions___model_compact-{i}.json"])
            for i in (1, 2)]
    assert all(len(c) == 4 for c in caps)
    assert caps[0] != caps[1]  # the two checkpoints are told apart
    assert {type(c["image_id"]) for c in caps[0]} == \
        {int if style == "coco" else str}
    assert {"Bleu_1", "Bleu_4", "ROUGE_L", "CIDEr"} <= set(tres[name])
    assert_both_native(ciderd_used)  # the same CIDEr-D on both sides


def test_evaluate_model_is_byte_identical(tmp_path, coco, ciderd_used):
    """evaluate_model on one checkpoint path, with its own pipeline."""
    from comic_tpu.inference import evaluate_model as jeval

    files = []
    for name, cfg, evaluate in (
            ("jax", JConfig, jeval),
            ("torch", Config, lambda *a: tinf.evaluate_model(
                *a, device="cpu"))):
        kw, log = _experiment(tmp_path, name, coco)
        config = cfg(**kw)
        scores = evaluate(config, os.path.join(log, "model_compact-2"),
                          coco[3])
        assert set(scores) >= {"Bleu_1", "CIDEr"}
        files.append(_outputs(os.path.join(log,
                                           tinf.infer_dir_name(config))))
    assert files[0] == files[1] and len(files[0]) == 4
    assert_both_native(ciderd_used)


def test_sweep_toggles_and_explicit_checkpoints(tmp_path, coco):
    """--infer_checkpoints lists and the run_inference / get_metric_score
    toggles (reference infer.py:37-50,99-102), as in
    tests/test_inference.py."""
    kw, log = _experiment(tmp_path, "toggles", coco)
    config, ann = Config(**kw), coco[3]

    def sweep(**k):
        return tinf.sweep_checkpoints(config, annotations_file=ann,
                                      device="cpu", **k)

    # scoring off: the captions are written, no scores come back
    assert sweep(checkpoints="2", get_metric_score=False) == {}
    save_dir = os.path.join(log, tinf.infer_dir_name(config))
    assert sorted(os.listdir(save_dir)) == [
        "captions___model_compact-2.json", "infer_speed.txt"]
    # inference off: scores from the existing JSON; none for a checkpoint
    # without one
    assert list(sweep(checkpoints="2", run_infer=False)) == [
        "model_compact-2"]
    assert sweep(checkpoints="1", run_infer=False) == {}
    # an unknown checkpoint number warns and the sweep goes on
    assert sweep(checkpoints="999999", run_infer=False) == {}
    assert list(sweep(checkpoints="999999,1")) == ["model_compact-1"]
    # a JSON that exists is not captioned again
    with open(os.path.join(save_dir, "infer_speed.txt")) as f:
        assert len(f.read().splitlines()) == 2
    assert list(sweep()) == ["model_compact-1", "model_compact-2"]
    with open(os.path.join(save_dir, "infer_speed.txt")) as f:
        assert len(f.read().splitlines()) == 2
    with pytest.raises(ValueError, match="comma-separated"):
        tinf.sweep_checkpoints(config, checkpoints=",", device="cpu")
    empty = Config(**dict(kw, log_path=str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError, match="No compact checkpoints"):
        tinf.sweep_checkpoints(empty, device="cpu")


def test_evaluate_model_toggles(tmp_path, coco, capsys):
    kw, log = _experiment(tmp_path, "evaluate", coco)
    config = Config(**kw)
    path = os.path.join(log, "model_compact-1")
    assert tinf.evaluate_model(config, path, coco[3], run_infer=False,
                               device="cpu") is None
    assert "no caption JSON" in capsys.readouterr().out
    assert tinf.evaluate_model(config, path, None, device="cpu") is None
    assert "no annotation file" in capsys.readouterr().out
    # the annotation file may come from the config
    config.update(annotations_file=coco[3])
    assert "CIDEr" in tinf.evaluate_model(config, path, run_infer=False,
                                          device="cpu")


def test_sweep_refuses_a_multiprocess_job(tmp_path, coco, monkeypatch):
    kw, log = _experiment(tmp_path, "mp", coco)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    built = []
    monkeypatch.setattr(tinf, "InferencePipeline",
                        lambda *a, **k: built.append(1))
    with pytest.raises(NotImplementedError, match="single-process"):
        tinf.sweep_checkpoints(Config(**kw), coco[3], device="cpu")
    assert built == [] and sorted(os.listdir(log)) == [
        "model_compact-1.msgpack", "model_compact-2.msgpack"]


def _spy_pipe(monkeypatch):
    closed = []

    class SpyPipe(tinf.InferencePipeline):
        def close(self):
            closed.append(True)
            super().close()

    monkeypatch.setattr(tinf, "InferencePipeline", SpyPipe)
    return closed


def test_owned_pipelines_close_on_error(tmp_path, coco, monkeypatch):
    """An error while scoring closes the sweep's pipeline and propagates
    (only checkpoint resolution is forgiven); an error while building the
    serve fn closes run_inference's own pipeline."""
    kw, log = _experiment(tmp_path, "errors", coco)
    config = Config(**kw)
    bad_ann = tmp_path / "bad.json"
    bad_ann.write_text("{not json")
    closed = _spy_pipe(monkeypatch)
    with pytest.raises(json.JSONDecodeError):
        tinf.sweep_checkpoints(config, str(bad_ann), device="cpu")
    assert closed == [True]

    def boom(*a, **k):
        raise ValueError("injected serve failure")

    monkeypatch.setattr(tinf, "make_serve_fn", boom)
    with pytest.raises(ValueError, match="injected"):
        tinf.run_inference(config, os.path.join(log, "model_compact-2"),
                           device="cpu")
    assert closed == [True, True]


# --- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--infer_set", "coco_valid", "--infer_beam_size", "1"],
    ["--run_inference", "", "--get_metric_score", "0",
     "--save_attention_maps", "yes", "--require_ptb_jar", "1",
     "--infer_checkpoints", "3,5", "--packed_dataset", "p.h5",
     "--jar_dir", "jars", "--infer_early_exit", "0",
     "--infer_length_penalty_weight", "0.6", "--batch_size_infer", "5"]])
def test_parser_matches(argv):
    argv = ["--infer_checkpoints_dir", "exp"] + argv
    want = vars(jcli.create_parser().parse_args(argv))
    assert vars(tcli.create_parser().parse_args(argv)) == want
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            cli.create_parser().parse_args(argv + ["--infer_set", "train"])


@pytest.fixture
def saved_experiment(tmp_path, coco):
    """An experiment dir with a config.pkl (the port's Config.save) and the
    two compact checkpoints."""
    kw, log = _experiment(tmp_path, "exp", coco, infer_beam_size=2)
    Config(**kw).save(log)
    return log


@pytest.mark.parametrize("argv", [
    [], ["--infer_set", "coco_valid", "--batch_size_infer", "7"],
    ["--infer_set", "valid", "--dataset_dir", "other", "--packed_dataset",
     "p.h5", "--infer_beam_size", "5", "--infer_max_length", "12",
     "--infer_early_exit", "0", "--infer_length_penalty_weight", "0.6"]])
def test_config_matches(saved_experiment, monkeypatch, argv):
    """The config the port's CLI sweeps with equals the one comic_tpu's
    main hands its sweep; coco_valid forces the batch of 61."""
    argv = ["--infer_checkpoints_dir", saved_experiment] + argv
    seen = {}

    def capture(config, *a, **k):
        seen.update(config=config, args=a, kwargs=k)
        return {}

    monkeypatch.setattr(jcli, "sweep_checkpoints", capture)
    jcli.main(argv)
    args, config = tcli.infer_config(argv)
    assert config.to_dict() == seen["config"].to_dict()
    assert (args.annotations_file, args.jar_dir) == seen["args"]
    if "coco_valid" in argv:
        assert config.batch_size_infer == 61


def test_main_needs_the_card(saved_experiment):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--infer_checkpoints_dir", saved_experiment])


def test_main_prints_the_same_lines(saved_experiment, coco, capsys):
    """Scoring from existing caption JSONs (--run_inference ''), which needs
    no device: both mains print one `name: k=v` line per checkpoint."""
    config = Config(**dict(CONFIG, log_path=saved_experiment,
                           infer_beam_size=2, wtoi=coco[1]["wtoi"],
                           itow=coco[1]["itow"], dataset_dir=coco[0]))
    tinf.run_inference(config, os.path.join(saved_experiment,
                                            "model_compact-1"), device="cpu")
    argv = ["--infer_checkpoints_dir", saved_experiment, "--run_inference",
            "", "--infer_beam_size", "2", "--annotations_file", coco[3]]
    lines = []
    for cli in (jcli, tcli):
        capsys.readouterr()
        results = cli.main(argv)
        assert list(results) == ["model_compact-1"]
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("model_compact-")])
    assert lines[0] == lines[1] and len(lines[1]) == 1
    assert lines[1][0].startswith("model_compact-1: Bleu_1=")


def test_train_cli_joins_a_two_process_job(tmp_path):
    """Under COMIC_COORDINATOR the train CLI joins the job (gloo, on the
    CPU), trains the decoder stage on the global batch, and rank 0 alone
    writes the run: one config record, one model_size.txt stanza, each
    event once, one pair of checkpoints, which comic_tpu loads."""
    import torch_multiprocess_worker as worker
    from flax import serialization

    from comic_tpu.configuration import load_config as jload_config
    from comic_tpu.training import checkpoints as jckpt

    data, _ = make_synthetic_dataset(str(tmp_path / "data"), num_train=8,
                                     num_valid=4, num_test=4,
                                     captions_per_image=1)
    root = tmp_path / "runs"
    work = tmp_path / "job"
    work.mkdir()
    argv = ["--name", "dp", "--log_root", str(root), "--dataset_dir", data,
            "--dataset_file_pattern", "synth_{}", "--radix_base", "16",
            "--rnn_size", "16", "--rnn_word_size", "8", "--attn_num_heads",
            "2", "--cnn_input_size", "64,64", "--compute_dtype", "float32",
            "--batch_size_train", "2", "--batch_size_eval", "4",
            "--max_epoch", "1"]
    with open(work / "argv.json", "w") as f:
        json.dump(argv, f)
    ranks = worker.run_job("train_cli", work, timeout=150)
    assert [str(r["backend"]) for r in ranks] == ["gloo", "gloo"]
    assert float(ranks[0]["total_loss"]) == float(ranks[1]["total_loss"])
    runs = os.listdir(root)
    assert len(runs) == 1 and not runs[0].startswith("error__")
    log = os.path.join(root, runs[0])
    files = sorted(os.listdir(log))
    # 8 records, 2 a rank: 2 global steps in the epoch
    assert [f for f in files if not f.startswith(("config___",
                                                 "events.out"))] == [
        "config.pkl", "events.jsonl", "input_image___0.png",
        "model-2.msgpack", "model_compact-2.msgpack", "model_size.txt"]
    assert sum(f.startswith("config___") for f in files) == 1
    assert sum(f.startswith("events.out") for f in files) <= 1
    with open(os.path.join(log, "model_size.txt")) as f:
        assert f.read().count("INFO: Scope `decoder`") == 1
    with open(os.path.join(log, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["step"] for e in events] == [1, 2, 2]
    assert "eval_perplexity" in events[-1]
    assert jload_config(log).batch_size_train == 2
    path = os.path.join(log, "model_compact-2.msgpack")
    with open(path, "rb") as f:
        template = serialization.msgpack_restore(f.read())
    restored = jckpt.load_compact(path, template)
    assert set(restored) == {"encoder", "decoder"}


def test_infer_cli_joins_then_refuses_the_multiprocess_sweep(
        saved_experiment, tmp_path):
    """Under COMIC_COORDINATOR the infer CLI joins the job and then refuses
    the sweep on every rank, as comic_tpu does, before writing anything."""
    import torch_multiprocess_worker as worker

    argv = ["--infer_checkpoints_dir", saved_experiment,
            "--annotations_file", "ann.json"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(argv, f)
    before = sorted(os.listdir(saved_experiment))
    ranks = worker.run_job("infer_cli", tmp_path, timeout=120)
    for r in ranks:
        assert str(r["backend"]) == "gloo" and int(r["world"]) == 2
        assert "multi-process" in str(r["refused"])
    assert sorted(os.listdir(saved_experiment)) == before
