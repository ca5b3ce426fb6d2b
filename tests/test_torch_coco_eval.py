"""comic_tpu_torch's COCO scoring against comic_tpu's on the CPU: ROUGE-L,
the PTB tokenizer (Python fallback and the CoreNLP jar path), METEOR and
SPICE over fake jars, the evaluator's guards, evaluate_captions and the
score artifacts, and the packed-HDF5 image source of the inference
pipeline. Inputs are seeded numpy corpora; scores agree to 1e-12 and the
artifacts are byte-identical."""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from comic_tpu.evaluation import coco_eval as jcoco
from comic_tpu.evaluation import java_metrics as jjava
from comic_tpu.evaluation import rouge as jrouge
from comic_tpu.evaluation import tokenizer as jtok
from comic_tpu_torch.evaluation import coco_eval as tcoco
from comic_tpu_torch.evaluation import java_metrics as tjava
from comic_tpu_torch.evaluation import rouge as trouge
from comic_tpu_torch.evaluation import tokenizer as ttok
from test_torch_native_ciderd import (  # noqa: F401 (fixtures)
    assert_both_native, ciderd_used, native_ciderd)

torch.set_num_threads(1)

PACKAGES = {"jax": (jcoco, jjava, jtok), "torch": (tcoco, tjava, ttok)}

_WORDS = ["a", "man", "dog", "cat", "riding", "on", "the", "beach", "red",
          "bike", "is", "near", "two", "people", "with", "of", "street"]
# pieces that exercise the PTB rules: contractions, clitics, brackets,
# quotes, hyphens, numbers, ellipses, unicode, punctuation
_PIECES = ["don't", "it's", "they're", "cannot", "gonna", "(small)",
           "[on", "mat]", "{x}", '"hello"', "well-lit", "--", "...", "1,000",
           "3.5", "$5", "café", "o'clock", "cats'", "“fancy”", "too…", ",",
           ".", "!", "?", ";", ":", "-", "'", "A", "Dog", "RED"]


def _caption(rng, lo=3, hi=12, tricky=0.0):
    n = int(rng.integers(lo, hi))
    out = []
    for _ in range(n):
        pool = _PIECES if rng.random() < tricky else _WORDS
        out.append(pool[int(rng.integers(len(pool)))])
    return " ".join(out)


def _ids(n, kind):
    if kind == "int":
        return [int(i) * 7 + 3 for i in range(n)]
    return [f"user{i}@post" for i in range(n)]


def _corpus(seed, n, kind, refs=5, tricky=0.2):
    """-> (annotations JSON dict, result list): seeded references and
    hypotheses; the hypotheses share words with the references."""
    rng = np.random.default_rng(seed)
    ids = _ids(n, kind)
    anns, res = [], []
    for i in ids:
        caps = [_caption(rng, tricky=tricky) for _ in range(refs)]
        anns += [{"image_id": i, "caption": c} for c in caps]
        words = caps[0].split()[: int(rng.integers(2, 6))]
        res.append({"image_id": i,
                    "caption": " ".join(words + [_caption(rng, 1, 5)])})
    return {"annotations": anns}, res


@pytest.mark.parametrize("kind", ["int", "str"])
def test_rouge_matches(kind):
    ann, res = _corpus(1, 40, kind, tricky=0.0)
    gts, hyp = {}, {}
    for a in ann["annotations"]:
        gts.setdefault(a["image_id"], []).append(a["caption"])
    for r in res:
        hyp[r["image_id"]] = [r["caption"]]
    want = jrouge.rouge_l(gts, hyp)
    got = trouge.rouge_l(gts, hyp)
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    assert 0 < got[0] < 1
    assert trouge.RougeScorer().method() == jrouge.RougeScorer().method()


def test_ptb_fallback_matches():
    rng = np.random.default_rng(2)
    lines = [_caption(rng, 1, 15, tricky=0.6) for _ in range(300)]
    lines += ["", "a\nb", "A (small) dog [on a mat] {sleeping}",
              'He said "hello world" loudly.']
    for line in lines:
        assert ttok._python_tokenize_line(line) == \
            jtok._python_tokenize_line(line)
    caps = {i: [{"caption": c}] for i, c in enumerate(lines)}
    tok = ttok.PTBTokenizer("")
    assert not tok.used_fallback
    assert tok.tokenize(caps) == jtok.PTBTokenizer("").tokenize(caps)
    assert tok.used_fallback
    # the reference's upper-case punctuation filter keeps the brackets
    assert ttok._python_tokenize_line("a (dog)") == "a -lrb- dog -rrb-"
    assert ttok.tokenize_simple({1: ["It's a dog."]}) == \
        jtok.tokenize_simple({1: ["It's a dog."]})


def _write_artifacts(pkg, save_dir, scores, per_image):
    """Two appends with the same metric set, then one with valid_ppl (the
    csv header is emitted again)."""
    pkg.write_score_artifacts(save_dir, "model_compact-1", scores, per_image)
    pkg.write_score_artifacts(save_dir, "model_compact-2", scores, per_image)
    pkg.write_score_artifacts(save_dir, "model_compact-3", scores, per_image,
                              valid_ppl=12.5)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _score_both(tmp_path, ann, res, jar_dir=""):
    """evaluate_captions and write_score_artifacts of both packages on the
    same files -> {package: (scores, per-image, artifact bytes)}."""
    ann_path, res_path = tmp_path / "ann.json", tmp_path / "res.json"
    ann_path.write_text(json.dumps(ann))
    res_path.write_text(json.dumps(res))
    out = {}
    for name, (coco, _, _) in PACKAGES.items():
        scores, per_image = coco.evaluate_captions(str(ann_path),
                                                   str(res_path), jar_dir)
        save_dir = str(tmp_path / name)
        _write_artifacts(coco, save_dir, scores, per_image)
        out[name] = (scores, per_image, _files(save_dir))
    return out


def _assert_same_scores(out, metrics):
    (js, jper, jfiles), (ts, tper, tfiles) = out["jax"], out["torch"]
    assert list(ts) == list(js)
    assert set(ts) == set(metrics)
    for m in js:
        assert ts[m] == pytest.approx(js[m], abs=1e-12, nan_ok=True)
    assert list(tper) == list(jper)
    for k in jper:
        assert list(tper[k]) == list(jper[k])
        for m in metrics:
            assert tper[k][m] == pytest.approx(jper[k][m], abs=1e-12,
                                               nan_ok=True)
    assert tfiles == jfiles
    assert sorted(tfiles) == ["metric_scores.csv", "metric_scores.txt",
                              "metric_scores_detailed_0.json",
                              "metric_scores_detailed_1.json",
                              "metric_scores_detailed_2.json"]
    return tfiles


@pytest.mark.parametrize("kind", ["int", "str"])
def test_evaluate_captions_and_artifacts_match(tmp_path, kind, ciderd_used):
    ann, res = _corpus(3, 60, kind)
    out = _score_both(tmp_path, ann, res)
    files = _assert_same_scores(out, ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                      "ROUGE_L", "CIDEr"])
    assert_both_native(ciderd_used)
    scores = out["torch"][0]
    assert all(np.isfinite(v) and v > 0 for v in scores.values())
    csv = files["metric_scores.csv"].decode().splitlines()
    assert csv[0] == "checkpoint,Bleu_1,Bleu_2,Bleu_3,Bleu_4,ROUGE_L,CIDEr"
    assert csv[3] == csv[0] + ",valid_ppl" and len(csv) == 5
    assert files["metric_scores.txt"].decode().count("checkpoint") == 1
    detail = json.loads(files["metric_scores_detailed_0.json"])
    assert [d["CIDEr"] for d in detail] == sorted(d["CIDEr"] for d in detail)
    assert {type(d["image_id"]) for d in detail} == \
        {int if kind == "int" else str}


def test_load_results_and_annotations_match(tmp_path):
    """Numeric ids arrive as ints whether the JSON holds 5 or "5"."""
    p = tmp_path / "x.json"
    p.write_text(json.dumps([{"image_id": "5", "caption": "a"},
                             {"image_id": 7, "caption": "b"},
                             {"image_id": "u@p", "caption": "c"}]))
    assert tcoco.load_results(str(p)) == jcoco.load_results(str(p))
    assert list(tcoco.load_results(str(p))) == [5, 7, "u@p"]
    p.write_text(json.dumps({"annotations": [
        {"image_id": "5", "caption": "a"}, {"image_id": 5, "caption": "b"}]}))
    assert tcoco.load_annotations(str(p)) == jcoco.load_annotations(str(p))
    assert tcoco.METRIC_ORDER == jcoco.METRIC_ORDER


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_evaluator_guards(name, capsys, monkeypatch):
    coco, _, tok = PACKAGES[name]
    gts = {1: [{"caption": "a dog runs"}], 2: [{"caption": "a cat"}]}
    # disjoint ids would score all zeros: refused
    with pytest.raises(ValueError, match="No result image id"):
        coco.CocoCaptionEvaluator().evaluate(gts, {9: [{"caption": "x"}]})
    # an id without annotations is dropped with a warning on stderr
    ev = coco.CocoCaptionEvaluator()
    ev.evaluate(gts, {1: [{"caption": "a dog runs"}],
                      9: [{"caption": "x"}]})
    err = capsys.readouterr()
    assert "1 of 2 result images" in err.err and "fallback" in err.err
    assert "fallback" not in err.out
    assert list(ev.img_to_eval) == [1]
    # a parity run refuses the fallback before tokenizing...
    strict = coco.CocoCaptionEvaluator(require_ptb_jar=True)
    with pytest.raises(RuntimeError, match="parity"):
        strict.evaluate(gts, gts)
    # ...and after a tokenization that fell back although the pre-check
    # saw the jar
    calls = []

    def first_call_only(jar_dir=""):
        calls.append(jar_dir)
        return len(calls) == 1

    monkeypatch.setattr(tok, "java_available", first_call_only)
    if hasattr(coco, "java_available"):
        monkeypatch.setattr(coco, "java_available", first_call_only)
    with pytest.raises(RuntimeError, match="used the Python fallback"):
        coco.CocoCaptionEvaluator(require_ptb_jar=True).evaluate(gts, gts)


# fakes of the three jars, run through a fake `java` on PATH (the pattern
# of tests/test_java_metrics.py and tests/test_tokenizer_parity.py)
_FAKE_METEOR = """#!{python}
import sys
# meteor-1.5.jar -stdio: SCORE ||| refs ||| hypo -> one stats line;
# EVAL ||| stats... -> one score per segment, then the final score. A hypo
# holding the word 'crash' ends the process mid-protocol.
for line in sys.stdin:
    line = line.rstrip("\\n")
    if line.startswith("SCORE"):
        parts = line.split(" ||| ")
        if "crash" in parts[-1].split():
            sys.exit(3)
        print(f"{{len(parts)}} {{len(parts[-1].split())}}")
        sys.stdout.flush()
    elif line.startswith("EVAL"):
        segs = line.split(" ||| ")[1:]
        scores = [float(s.split()[1]) / (10.0 + float(s.split()[0]))
                  for s in segs]
        for s in scores:
            print(repr(s))
        print(repr(sum(scores) / len(scores)))
        sys.stdout.flush()
"""

_FAKE_SPICE = """#!{python}
import json, os, sys
# spice-1.0.jar: in.json -cache C -out out.json; an f-score of null for a
# one-word hypothesis; records the cache directory it was given
args = sys.argv[1:]
in_path = args[args.index("-jar") + 3]
out_path = args[args.index("-out") + 1]
cache = args[args.index("-cache") + 1]
with open(os.path.join(os.path.dirname(cache), "cache_seen.txt"), "a") as f:
    f.write(cache + "\\n")
with open(in_path) as f:
    data = json.load(f)
out = []
for d in data:
    n = len(d["test"].split())
    f = None if n == 1 else n / (n + len(d["refs"]))
    out.append({{"image_id": d["image_id"],
                "scores": {{"All": {{"f": f, "pr": 0.5, "re": None}},
                           "Object": {{"f": 0.25}}}}}})
with open(out_path, "w") as f:
    json.dump(out, f)
"""

_FAKE_PTB = """#!{python}
import sys
# the CoreNLP PTBTokenizer under -preserveLines -lowerCase: one output line
# per input line, empty lines kept; a final '.' is split off and a word's
# brackets become upper-case tokens (which the filter drops)
data = sys.stdin.read()
out = []
for line in data.split("\\n"):
    words = []
    for w in line.lower().split():
        if w.endswith(".") and len(w) > 1:
            words += [w[:-1], "."]
        elif w == "(":
            words.append("-LRB-")
        else:
            words.append(w)
    out.append(" ".join(words))
sys.stdout.write("\\n".join(out) + "\\n")
"""


@pytest.fixture
def fake_jars(tmp_path, monkeypatch):
    """A fake `java` on PATH dispatching on the jar it is given, and empty
    placeholder jars, so that every Java path is available."""
    d = tmp_path / "jars"
    bindir = d / "bin"
    bindir.mkdir(parents=True)
    scripts = {"meteor.py": _FAKE_METEOR, "spice.py": _FAKE_SPICE,
               "ptb.py": _FAKE_PTB}
    for name, body in scripts.items():
        (d / name).write_text(body.format(python=sys.executable))
    java = bindir / "java"
    java.write_text(
        "#!/bin/sh\n"
        f'case "$*" in *{jjava.METEOR_JAR}*) exec "{d}/meteor.py";;'
        f' *{jjava.SPICE_JAR}*) exec "{d}/spice.py" "$@";;'
        f' *{jtok.CORENLP_JAR}*) exec "{d}/ptb.py";; esac\n'
        "exit 9\n")
    for f in [java] + [d / n for n in scripts]:
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    for jar in (jjava.METEOR_JAR, jjava.SPICE_JAR, jtok.CORENLP_JAR):
        (d / jar).write_text("")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return str(d)


def test_meteor_matches_over_the_line_protocol(fake_jars):
    gts = {1: ["a cat ||| sits", "a  cat"], "u@p": ["dogs run fast"],
           3: ["x y"]}
    res = {1: ["one ||| two three"], "u@p": ["one two three four"],
           3: ["crash now"]}
    outs = []
    for name in ("jax", "torch"):
        m = PACKAGES[name][1].MeteorScorer(fake_jars)
        assert m.available() and m.method() == "METEOR"
        ok = {k: res[k] for k in (1, "u@p")}
        first = m.compute_score({k: gts[k] for k in ok}, ok)
        proc = m._proc
        assert m.compute_score({k: gts[k] for k in ok}, ok) == first
        assert m._proc is proc  # one process serves every call
        with pytest.raises(Exception):
            m.compute_score(gts, res)  # dies mid-protocol
        assert m._proc is None  # closed, so the next call restarts
        assert m.compute_score({k: gts[k] for k in ok}, ok) == first
        m.close()
        outs.append(first)
    assert outs[0] == outs[1]
    # the separators were removed: 4 fields a SCORE line for image 1, and
    # the hypothesis is 3 words
    assert outs[1][1][0] == pytest.approx(3 / 14)


def test_spice_matches_and_propagates_null(fake_jars):
    gts = {7: ["a reference", "another one"], "s@id": ["x"], 2: ["y z"]}
    res = {7: ["one two"], "s@id": ["one two three"], 2: ["single"]}
    outs = []
    for name in ("jax", "torch"):
        s = PACKAGES[name][1].SpiceScorer(fake_jars)
        assert s.available() and s.method() == "SPICE"
        outs.append(s.compute_score(gts, res))
    (jfinal, jper), (tfinal, tper) = outs
    assert np.isnan(jfinal) and np.isnan(tfinal)  # a null f propagates
    assert json.dumps(tper) == json.dumps(jper)
    assert np.isnan(tper[2]["All"]["f"]) and np.isnan(tper[0]["All"]["re"])
    assert tper[1]["All"]["f"] == pytest.approx(0.75)
    with open(os.path.join(fake_jars, "cache_seen.txt")) as f:
        caches = f.read().split()
    assert caches == [os.path.join(fake_jars, "spice_cache")] * 2
    assert tjava.float_convert(None) != tjava.float_convert(None)
    assert tjava.float_convert("0.5") == 0.5


def test_unavailable_java_metrics_refuse(tmp_path):
    for name in ("jax", "torch"):
        java = PACKAGES[name][1]
        for cls in (java.MeteorScorer, java.SpiceScorer):
            s = cls(str(tmp_path))
            assert not s.available()
            with pytest.raises(RuntimeError, match="not available"):
                s.compute_score({1: ["r"]}, {1: ["h"]})


def test_ptb_jar_path_matches(fake_jars):
    caps = {1: [{"caption": "A dog ( runs."}, {"caption": ""}],
            "u@p": [{"caption": "Two\ncats sit."}]}
    outs = []
    for name in ("jax", "torch"):
        tok = PACKAGES[name][2]
        assert tok.java_available(fake_jars)
        t = tok.PTBTokenizer(fake_jars)
        outs.append(t.tokenize(caps))
        assert not t.used_fallback
    assert outs[0] == outs[1]
    assert outs[1] == {1: ["a dog runs", ""], "u@p": ["two cats sit"]}


@pytest.mark.parametrize("kind", ["int", "str"])
def test_evaluate_captions_with_every_metric_matches(tmp_path, fake_jars,
                                                     kind, ciderd_used):
    """With Java and the three jars the evaluator tokenizes through the
    jar and adds METEOR and SPICE; both packages' scores and artifacts
    agree (a hypothesis of one word makes SPICE NaN)."""
    ann, res = _corpus(5, 30, kind, tricky=0.0)
    res[4]["caption"] = "dog"
    out = _score_both(tmp_path, ann, res, jar_dir=fake_jars)
    files = _assert_same_scores(out, tcoco.METRIC_ORDER)
    assert_both_native(ciderd_used)
    assert files["metric_scores.txt"].decode().splitlines()[0] == \
        "checkpoint\t" + "\t".join(tcoco.METRIC_ORDER)
    assert np.isnan(out["torch"][0]["SPICE"])


def test_require_ptb_jar_threads_through(tmp_path):
    ann, res = _corpus(6, 3, "int")
    (tmp_path / "a.json").write_text(json.dumps(ann))
    (tmp_path / "r.json").write_text(json.dumps(res))
    for name in ("jax", "torch"):
        with pytest.raises(RuntimeError, match="parity"):
            PACKAGES[name][0].evaluate_captions(
                str(tmp_path / "a.json"), str(tmp_path / "r.json"),
                jar_dir="", require_ptb_jar=True)


def test_caption_json_matches(tmp_path):
    ids, caps = [5, "7", "u@p"], ["a dog", "two cats", "é"]
    jcoco.write_caption_json(str(tmp_path / "j.json"), ids, caps)
    tcoco.write_caption_json(str(tmp_path / "t.json"), ids, caps)
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()


# --- the packed-HDF5 image source -----------------------------------------

@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A synthetic dataset (JPEG files) and its pack, written by
    comic_tpu.prepro."""
    pytest.importorskip("h5py")
    from comic_tpu.data.synthetic import make_synthetic_dataset
    from comic_tpu.prepro.base import serialise_everything

    tmp = tmp_path_factory.mktemp("packed")
    root, vocab = make_synthetic_dataset(str(tmp / "d"), num_train=4,
                                         num_valid=2, num_test=4,
                                         captions_per_image=1)
    txt = {}
    for split in ("train", "valid", "test"):
        with open(os.path.join(root, "captions", f"synth_{split}.txt")) as f:
            txt[split] = [ln.strip() for ln in f if ln.strip()]
    h5 = serialise_everything(str(tmp / "pack"), root, (256, 256), 2, txt,
                              vocab.wtoi, vocab.itow)
    return root, h5, tmp


def _sources(h5):
    from comic_tpu.data.pipeline import PackedImageSource as JSource
    from comic_tpu_torch.data.pipeline import PackedImageSource as TSource

    return JSource(h5), TSource(h5)


def test_packed_source_serves_the_same_rows(packed):
    root, h5, _ = packed
    js, ts = _sources(h5)
    try:
        assert ts._index == js._index and ts._by_base == js._by_base
        paths = list(js._index)
        base = paths[0].rsplit("/", 1)[-1]
        for query in (paths, [base], ["/abs/data/" + paths[1]]):
            got = ts.load(query)
            assert got.dtype == np.uint8 and got.shape[1:] == (256, 256, 3)
            np.testing.assert_array_equal(got, js.load(query))
        for query, match in ((["elsewhere/" + base], "different directories"),
                             (["nope.jpg"], "not in the packed dataset")):
            for src in (js, ts):
                with pytest.raises(KeyError, match=match):
                    src.load(query)
    finally:
        js.close()
        ts.close()


def test_packed_source_refuses_an_ambiguous_basename(packed):
    import shutil

    import h5py

    root, h5, tmp = packed
    clash_h5 = str(tmp / "clash.h5")
    shutil.copy(h5, clash_h5)
    with h5py.File(clash_h5, "r+") as f:
        lines = [ln.decode() if isinstance(ln, bytes) else ln
                 for ln in f["test"][:]]
        row0, path0 = lines[0].split(",", 2)[:2]
        row1 = next(ln.split(",", 2)[0] for ln in lines
                    if ln.split(",", 2)[0] != row0)
        base = path0.rsplit("/", 1)[-1]
        del f["test"]
        f.create_dataset(
            "test", data=np.asarray(
                lines + [f"{row1},other_dir/{base},a clash"], dtype=object),
            dtype=h5py.string_dtype())
    for src in _sources(clash_h5):
        try:
            assert src.load([path0]).shape == (1, 256, 256, 3)
            with pytest.raises(KeyError, match="multiple packed images"):
                src.load([base])
        finally:
            src.close()


def _infer_config(pkg_config, root, **kw):
    return pkg_config(dataset_dir=root, dataset_file_pattern="synth_{}",
                      infer_set="test", batch_size_infer=2, **kw)


def test_inference_pipeline_reads_the_pack(packed):
    """The port's InferencePipeline on the pack gives comic_tpu's batches,
    which are also the JPEG loader's; host_resize_tf1 is refused as in
    comic_tpu, and so is a vgg-family config (whose encoder the port
    refuses first)."""
    from comic_tpu.configuration import Config as JConfig
    from comic_tpu.data.pipeline import InferencePipeline as JPipe
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data.pipeline import InferencePipeline

    root, h5, _ = packed
    pipes = [InferencePipeline(_infer_config(Config, root,
                                             packed_dataset=h5)),
             JPipe(_infer_config(JConfig, root, packed_dataset=h5)),
             InferencePipeline(_infer_config(Config, root))]
    try:
        batches = [list(p) for p in pipes]
    finally:
        for p in pipes:
            p.close()
    assert len(batches[0]) == 2
    for other in batches[1:]:
        for (im, files), (im2, files2) in zip(batches[0], other):
            assert list(files) == list(files2)
            np.testing.assert_array_equal(im, im2)
    for pipe_cls, cfg in ((InferencePipeline, Config), (JPipe, JConfig)):
        with pytest.raises(ValueError, match="host_resize_tf1"):
            pipe_cls(_infer_config(cfg, root, packed_dataset=h5,
                                   host_resize_tf1=True))
    # a pack holds square-resized images: the aspect (vgg) host mode is
    # refused by both
    for pipe_cls, cfg in ((InferencePipeline, Config), (JPipe, JConfig)):
        with pytest.raises(ValueError, match="aspect"):
            pipe_cls(_infer_config(cfg, root, packed_dataset=h5,
                                   cnn_name="vgg_16"))


@pytest.mark.parametrize("extra", [{}, {"cnn_name": "vgg_16"},
                                   {"packed_dataset": "missing.h5"}])
def test_inference_pipeline_checks_the_batch_first(packed, monkeypatch,
                                                   extra):
    """A batch size that does not tile the file count fails with comic_tpu's
    ValueError before any loader is built (none is left open)."""
    from comic_tpu.configuration import Config as JConfig
    from comic_tpu.data.pipeline import InferencePipeline as JPipe
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data import pipeline as tpipe

    root, _, _ = packed
    built = []
    for name in ("_ImageLoaderPool", "PackedImageSource"):
        monkeypatch.setattr(tpipe, name,
                            lambda *a, name=name, **k: built.append(name))
    for pipe_cls, cfg in ((tpipe.InferencePipeline, Config),
                          (JPipe, JConfig)):
        c = cfg(dataset_dir=root, dataset_file_pattern="synth_{}",
                infer_set="test", batch_size_infer=3, **extra)
        with pytest.raises(ValueError, match="must divide file count 4"):
            pipe_cls(c)
    assert built == []
