"""comic_tpu_torch's SCST reward scorers against comic_tpu's on the same
captions: BLEU, CIDEr, CIDEr-D (Python and native, corpus and IDF-cache
modes), the IDF cache files, CaptionScorer.get_hypo_scores, and the
hypothesis re-encoding caption_strings_to_batched_ids. The scorers are the
same double-precision arithmetic in both packages: equal to 1e-12."""

import os
import pickle

import numpy as np
import pytest

from comic_tpu.evaluation.bleu import BleuScorer as JBleu
from comic_tpu.evaluation import cider as jcider
from comic_tpu.evaluation import ngrams as jngrams
from comic_tpu.evaluation.scorers import CaptionScorer as JScorer
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.tokenization import build_char_vocab as jchar_vocab
from comic_tpu.tokenization import caption_strings_to_batched_ids as jencode
from comic_tpu_torch.evaluation.bleu import BleuScorer as TBleu
from comic_tpu_torch.evaluation import cider as tcider
from comic_tpu_torch.evaluation import cider_native as tnative
from comic_tpu_torch.evaluation import ngrams as tngrams
from comic_tpu_torch.evaluation.ids import id_sort_key
from comic_tpu_torch.evaluation.scorers import CaptionScorer as TScorer
from comic_tpu_torch.tokenization import Vocabulary, build_char_vocab
from comic_tpu_torch.tokenization import caption_strings_to_batched_ids
from test_torch_native_ciderd import (  # noqa: F401 (fixtures)
    assert_both_native, ciderd_used, native_ciderd)

EXACT = dict(rtol=1e-12, atol=1e-12)
WORDS = ["a", "man", "dog", "riding", "on", "the", "beach", "red", "bike",
         "with", "cat", "sitting"]


def _corpus(seed, n_images=12, refs_per_image=5):
    """Seeded captions: references per image and a hypothesis per image,
    some empty or one word (the CIDEr-D bigram-length quirk)."""
    rng = np.random.default_rng(seed)

    def sent(lo, hi):
        return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))

    refs = [[sent(3, 10) for _ in range(refs_per_image)]
            for _ in range(n_images)]
    hyps = [sent(0, 9) for _ in range(n_images)]
    hyps[0], hyps[1] = "", "dog"
    return refs, hyps


def _gts_res(refs, hyps):
    return ({i: r for i, r in enumerate(refs)},
            {i: [h] for i, h in enumerate(hyps)})


@pytest.fixture(scope="module")
def idf_cache(tmp_path_factory):
    refs, _ = _corpus(7, n_images=30)
    cache = jngrams.build_idf_cache(refs)
    path = str(tmp_path_factory.mktemp("idf") / "synth_scst-words.p")
    jngrams.save_idf_cache(path, cache)
    return path, cache


def test_ids_sort_numerically_beyond_ten():
    keys = list(range(25)) + ["b", "a"]
    assert sorted(keys, key=id_sort_key) == list(range(25)) + ["a", "b"]


def test_ngrams_and_idf_cache_match(tmp_path, idf_cache):
    refs, hyps = _corpus(1)
    for s in hyps + refs[0]:
        assert tngrams.ngram_counts(s.split()) == \
            jngrams.ngram_counts(s.split())
    assert tngrams.document_frequency(refs) == \
        jngrams.document_frequency(refs)
    path, want = idf_cache
    got = tngrams.load_idf_cache(path)  # comic_tpu's file, read by the port
    assert dict(got["document_frequency"]) == dict(want["document_frequency"])
    assert got["ref_len"] == want["ref_len"] == 30.0  # the raw count
    mine = tngrams.build_idf_cache(refs)
    out = str(tmp_path / "port.p")
    tngrams.save_idf_cache(out, mine)
    back = jngrams.load_idf_cache(out)  # the port's file, read by comic_tpu
    assert dict(back["document_frequency"]) == \
        dict(jngrams.build_idf_cache(refs)["document_frequency"])
    assert back["document_frequency"]["no such", "ngram"] == 0.0
    # a legacy cache stores log(N): both convert it to the raw count
    legacy = str(tmp_path / "legacy.p")
    with open(legacy, "wb") as f:
        pickle.dump(dict(mine, ref_len=float(np.log(12.0))), f)
    assert tngrams.load_idf_cache(legacy)["ref_len"] == pytest.approx(12.0)
    assert jngrams.load_idf_cache(legacy)["ref_len"] == pytest.approx(12.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_bleu_matches(seed):
    gts, res = _gts_res(*_corpus(seed))
    got_corpus, got_per = TBleu(4).compute_score(gts, res)
    want_corpus, want_per = JBleu(4).compute_score(gts, res)
    np.testing.assert_allclose(got_corpus, want_corpus, **EXACT)
    np.testing.assert_allclose(got_per, want_per, **EXACT)


@pytest.mark.parametrize("mode", ["corpus", "idf"])
@pytest.mark.parametrize("metric", ["Cider", "CiderD"])
def test_cider_matches(idf_cache, mode, metric):
    gts, res = _gts_res(*_corpus(2))
    df = idf_cache[1] if mode == "idf" else None
    got = getattr(tcider, metric)(df).compute_score(gts, res)
    want = getattr(jcider, metric)(df).compute_score(gts, res)
    np.testing.assert_allclose(got[1], want[1], **EXACT)
    np.testing.assert_allclose(got[0], want[0], **EXACT)
    assert np.abs(want[1]).max() > 0.1  # the captions do overlap


@pytest.mark.parametrize("mode", ["corpus", "idf"])
def test_native_ciderd_matches_python(idf_cache, mode):
    """The port builds its own copy of the C++ scorer (csrc/ciderd.cpp)
    into comic_tpu_torch/_build/, and its scores equal the Python
    CIDEr-D's of both packages."""
    assert tnative.native_available(), tnative.build_error()
    assert os.path.dirname(tnative._library_path()).endswith(
        os.path.join("comic_tpu_torch", "_build"))
    gts, res = _gts_res(*_corpus(3))
    # repeated reference lists, as the SCST joint dict has them
    gts.update({k + 12: gts[k] for k in range(12)})
    res.update({k + 12: [h[0] + " dog"] for k, h in list(res.items())})
    df = idf_cache[1] if mode == "idf" else None
    native = tnative.make_ciderd(df)
    assert isinstance(native, tnative.NativeCiderD)
    got = native.compute_score(gts, res)
    for want in (tcider.CiderD(df).compute_score(gts, res),
                 jcider.CiderD(df).compute_score(gts, res)):
        np.testing.assert_allclose(got[1], want[1], **EXACT)
        np.testing.assert_allclose(got[0], want[0], **EXACT)


@pytest.mark.parametrize("weights", [
    {"ciderD": 1.0, "bleu": [0.0, 0.0, 0.0, 2.0]},  # the SCST defaults
    {"ciderD": 0.5, "cider": 0.3, "bleu": [1.0, 0.5, 0.25, 0.25]},
    {"bleu": [0.0, 1.0]}])
@pytest.mark.parametrize("best_hypo_only", [False, True])
@pytest.mark.parametrize("with_idf", [False, True])
def test_caption_scorer_matches(idf_cache, weights, best_hypo_only,
                                with_idf, ciderd_used):
    """get_hypo_scores at batch 12 x beam 7 (96 keys): hypotheses, sample
    and greedy scores equal comic_tpu's; the port runs the native
    CIDEr-D and says so."""
    refs, greedy = _corpus(4)
    _, more = _corpus(5, n_images=12 * 7)
    sample = [[h] for h in more]  # beam-major
    path = idf_cache[0] if with_idf else None
    tscorer, jscorer = TScorer(path, weights), JScorer(path, weights)
    assert tscorer.ciderd_impl == "native"
    got = tscorer.get_hypo_scores(refs, sample, [[g] for g in greedy],
                                  best_hypo_only=best_hypo_only)
    want = jscorer.get_hypo_scores(refs, sample, [[g] for g in greedy],
                                   best_hypo_only=best_hypo_only)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], **EXACT)
    np.testing.assert_allclose(got[2], want[2], **EXACT)
    assert got[1].shape == ((12,) if best_hypo_only else (84,))
    if "ciderD" in weights:
        assert_both_native(ciderd_used)


def test_caption_scorer_refuses_what_comic_tpu_refuses():
    for scorer in (TScorer(None, {"ciderD": 1.0}),
                   JScorer(None, {"ciderD": 1.0})):
        with pytest.raises(ValueError, match="multiple"):
            scorer.get_hypo_scores([["a"]] * 2, [["a"]] * 3, [["a"]] * 2)
    for scorer in (TScorer(None, {"ciderD": 0.0}),
                   JScorer(None, {"ciderD": 0.0})):
        with pytest.raises(ValueError, match="positive weight"):
            scorer.get_hypo_scores([["a"]], [["a"]], [["a"]])


WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "the": 3, "beach": 4,
        "<UNK>": 5, "<GO>": 6, "<EOS>": 7}


@pytest.mark.parametrize("token_type,base", [("word", None), ("radix", 4),
                                             ("radix", 256), ("char", None)])
def test_caption_strings_to_batched_ids_matches(token_type, base):
    """Exact ids: unknown words (<UNK>), a literal special token, an empty
    caption, padding to the longest row."""
    caps = ["a dog on the beach", "", "the zebra", "dog <GO> a",
            "a a a a a a a"]
    if token_type == "char":
        tv, jv = build_char_vocab(), jchar_vocab()
    else:
        tv, jv = Vocabulary(dict(WTOI)), JVocabulary(dict(WTOI))
    got = caption_strings_to_batched_ids(caps, token_type, tv, base)
    want = jencode(caps, token_type, jv, base)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any()
