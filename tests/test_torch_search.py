"""comic_tpu_torch's beam and greedy search against comic_tpu's and against
the independent numpy transcription of contrib's BeamSearchDecoder in
tests/test_beam_oracle.py. Ids and lengths exactly, scores to 1e-5."""

import jax
import numpy as np
import pytest
import torch

from comic_tpu.decoding import search as jsearch
from comic_tpu.models import attention as jatt
from comic_tpu.models.captioner import ModelSpec as JModelSpec
from comic_tpu.models.decoder import DecoderConfig as JDecoderConfig
from comic_tpu.models.decoder import decoder_init as jdecoder_init
from comic_tpu.models.decoder import initial_state as jinitial_state
from comic_tpu_torch import params as bridge
from comic_tpu_torch.decoding import search as tsearch
from comic_tpu_torch.models import attention as tatt
from comic_tpu_torch.models.captioner import ModelSpec
from comic_tpu_torch.models.decoder import DecoderConfig
from comic_tpu_torch.models.decoder import initial_state
from test_beam_oracle import oracle_beam_search

torch.set_num_threads(1)

V, START, END = 7, 5, 6
B, L, T = 3, 5, 12
SCORES = dict(rtol=1e-5, atol=1e-5)


def _specs(rnn_name="LSTM"):
    kw = dict(num_units=8, num_heads=2, memory_channels=8,
              fm_projection="tied")
    dkw = dict(token_type="word", softmax_size=V, rnn_name=rnn_name,
               rnn_size=8, word_size=4, init_method="first_input",
               image_embed_size=6, start_id=START, end_id=END)
    skw = dict(cnn_name="inception_v1", fm_endpoint="Mixed_4f",
               legacy=False, token_type="word", radix_base=None,
               compute_dtype=None)
    return (JModelSpec(decoder=JDecoderConfig(
                attention=jatt.AttentionConfig(**kw), **dkw), **skw),
            ModelSpec(decoder=DecoderConfig(
                attention=tatt.AttentionConfig(**kw), **dkw), **skw))


@pytest.fixture(scope="module", params=[7, 19])
def setup(request):
    seed = request.param
    jspec, tspec = _specs()
    p = jax.tree_util.tree_map(
        np.asarray, jdecoder_init(jax.random.PRNGKey(seed), jspec.decoder))
    # spread the logits so no two candidates sit within float32 noise, and
    # make EOS likely enough that hypotheses end before T
    p["output_projection"]["kernel"] = p["output_projection"]["kernel"] * 3
    p["output_projection"]["bias"] = np.where(np.arange(V) == END, 0.5,
                                              0.0).astype(np.float32)
    rng = np.random.default_rng(seed)
    im = rng.normal(size=(B, 6)).astype(np.float32)
    fm = rng.normal(size=(B, L, 8)).astype(np.float32)
    jmem = jatt.precompute(p["attention"], jspec.decoder.attention, fm)
    tp = bridge.from_jax_tree(p, "cpu")
    tmem = tatt.precompute(tp["attention"], tspec.decoder.attention,
                           torch.from_numpy(fm))
    return jspec, tspec, p, tp, im, jmem, tmem


def test_initial_state_matches(setup):
    jspec, tspec, p, tp, im, _, _ = setup
    want = jinitial_state(p, jspec.decoder, im)
    got = initial_state(tp, tspec.decoder, torch.from_numpy(im))
    for g, w in zip(jax.tree_util.tree_leaves(tuple(got.cell_state))
                    + [got.attention],
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_matches_comic_tpu(setup, alpha, early_exit):
    jspec, tspec, p, tp, im, jmem, tmem = setup
    jtop, jall = jsearch.beam_search_from_memory(
        p, jspec, im, jmem, beam_size=3, max_steps=T, length_penalty=alpha,
        collect_alignments=False, early_exit=early_exit)
    ttop, tall = tsearch.beam_search_from_memory(
        tp, tspec, torch.from_numpy(im), tmem, beam_size=3, max_steps=T,
        length_penalty=alpha, collect_alignments=False,
        early_exit=early_exit)
    np.testing.assert_array_equal(tall["ids"].numpy(), jall["ids"])
    np.testing.assert_allclose(tall["scores"].numpy(), jall["scores"],
                               **SCORES)
    np.testing.assert_array_equal(ttop.ids.numpy(), jtop.ids)
    np.testing.assert_array_equal(ttop.lengths.numpy(), jtop.lengths)


def test_beam_alignments_match(setup):
    jspec, tspec, p, tp, im, jmem, tmem = setup
    jtop, _ = jsearch.beam_search_from_memory(
        p, jspec, im, jmem, beam_size=3, max_steps=T,
        collect_alignments=True)
    ttop, _ = tsearch.beam_search_from_memory(
        tp, tspec, torch.from_numpy(im), tmem, beam_size=3, max_steps=T,
        collect_alignments=True)
    np.testing.assert_array_equal(ttop.ids.numpy(), jtop.ids)
    np.testing.assert_allclose(ttop.alignments.numpy(), jtop.alignments,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_matches_oracle(setup, alpha, early_exit):
    jspec, tspec, p, tp, im, jmem, tmem = setup
    want_ids, want_scores, want_lens = oracle_beam_search(
        p, jspec, im, jmem, k=3, max_steps=T, alpha=alpha)
    top, all_beams = tsearch.beam_search_from_memory(
        tp, tspec, torch.from_numpy(im), tmem, beam_size=3, max_steps=T,
        length_penalty=alpha, collect_alignments=False,
        early_exit=early_exit)
    np.testing.assert_array_equal(
        all_beams["ids"].numpy().transpose(1, 0, 2), want_ids)
    np.testing.assert_allclose(
        all_beams["scores"].numpy().transpose(1, 0), want_scores, **SCORES)
    np.testing.assert_array_equal(top.lengths.numpy(), want_lens[:, 0])


@pytest.mark.parametrize("early_exit,collect", [(False, False), (True, False),
                                                (False, True)])
def test_greedy_matches_comic_tpu(setup, early_exit, collect):
    jspec, tspec, p, tp, im, jmem, tmem = setup
    want = jsearch.greedy_or_sample_from_memory(
        p, jspec, im, jmem, max_steps=T, collect_alignments=collect,
        early_exit=early_exit)
    got = tsearch.greedy_or_sample_from_memory(
        tp, tspec, torch.from_numpy(im), tmem, max_steps=T,
        collect_alignments=collect, early_exit=early_exit)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, **SCORES)
    np.testing.assert_allclose(got.alignments.numpy(), want.alignments,
                               rtol=1e-5, atol=1e-6)


def test_fixture_ends_hypotheses_early(setup):
    """The early-exit cases above are only meaningful if searches end
    before T: each seed has beams or greedy rows that do."""
    jspec, _, p, _, im, jmem, _ = setup
    top, _ = jsearch.beam_search_from_memory(
        p, jspec, im, jmem, beam_size=3, max_steps=T, collect_alignments=False)
    greedy = jsearch.greedy_or_sample_from_memory(
        p, jspec, im, jmem, max_steps=T, collect_alignments=False)
    assert (np.asarray(top.lengths) < T).any() or \
        (np.asarray(greedy.lengths) < T).any()


def test_ties_break_to_lowest_flat_index():
    """Equal candidates: lax.top_k order (lowest flat index first), which
    torch.topk does not promise; the search sorts stably instead."""
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    want_v, want_i = jax.lax.top_k(scores.numpy(), 3)
    np.testing.assert_array_equal(idx[:, :3].numpy(), want_i)
    np.testing.assert_array_equal(top[:, :3].numpy(), want_v)
