"""The decoder in bfloat16 against comic_tpu's on the CPU, at U=32 with 2
add_LN heads: the logits of the teacher-forced decode and of beam-grouped
decode steps (the serving step, K1's path) within 1e-6 of the logits'
largest magnitude. Both packages round the same operands to bfloat16 at
the same places (the cell's and the projections' matmul inputs, the stored
keys, the projected query and the alignments); what remains is float32
summation order. A misplaced rounding shows as ~1e-3 of the scale (one
bf16 step) on every row, three orders above the bound; an ulp of
summation order shows the same way on a single row when it carries a
value across a bf16 rounding boundary, which the step test tells apart
(test_step_grouped_bf16_logits_match)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.models import attention as jatt
from comic_tpu.models import captioner as jcap
from comic_tpu.models import decoder as jdec
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import attention as tatt
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.models.cells import LSTMState
from comic_tpu_torch.models import decoder as tdec
from comic_tpu_torch.tokenization import Vocabulary

torch.set_num_threads(1)

WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}
CFG = dict(token_type="radix", radix_base=16, rnn_size=32, rnn_word_size=16,
           attn_num_heads=2, compute_dtype="bfloat16",
           cnn_input_size=(64, 64))
# of the logits' largest magnitude
TOL = 1e-6
B, K, L, STEPS = 3, 3, 10, 6


@pytest.fixture(scope="module", params=[1, 5])
def setup(request):
    seed = request.param
    jspec = jcap.build_model_spec(JConfig(**CFG), JVocabulary(dict(WTOI)))
    tspec = tcap.build_model_spec(Config(**CFG), Vocabulary(dict(WTOI)))
    assert jspec.decoder.attention.num_units == 32
    pj = jax.tree_util.tree_map(np.asarray, jdec.decoder_init(
        jax.random.PRNGKey(seed), jspec.decoder))
    rng = np.random.default_rng(seed)
    im_embed = rng.normal(size=(B, 1024)).astype(np.float32)
    fmap = rng.normal(size=(B, L, 832)).astype(np.float32)
    return (jspec.decoder, tspec.decoder, pj, bridge.from_jax_tree(pj, "cpu"),
            rng, im_embed, fmap)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale, err / scale)


def test_teacher_forced_bf16_logits_match(setup):
    cfg_j, cfg_t, pj, pt, rng, im_embed, fmap = setup
    softmax = cfg_t.softmax_size
    inputs = np.full((B, STEPS), -1, np.int32)
    inputs[:, 0] = softmax - 2
    for i in range(B):
        n = int(rng.integers(2, STEPS))
        inputs[i, 1:n] = rng.integers(0, softmax - 2, n - 1)
    logits_j, _ = jdec.teacher_forced(
        pj, cfg_j, jnp.asarray(inputs), jnp.asarray(im_embed),
        jnp.asarray(fmap), dtype=jnp.bfloat16)
    with torch.no_grad():
        logits_t, _ = tdec.teacher_forced(
            pt, cfg_t, torch.from_numpy(inputs), torch.from_numpy(im_embed),
            torch.from_numpy(fmap), dtype=torch.bfloat16)
    assert logits_t.shape == logits_j.shape
    _close(logits_t, logits_j, "teacher_forced")


def _rows_close(got, want, rows, what):
    """``got`` against ``want`` (leading axis: the B * K hypotheses) on
    ``rows``, within TOL of ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32).reshape(len(rows), -1)
    got = got.float().numpy().reshape(len(rows), -1)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want)[rows].max())
    assert err <= TOL * scale, (what, err, scale, err / scale)


def test_step_grouped_bf16_logits_match(setup):
    """STEPS beam-grouped steps on B images x K hypotheses fed the same
    ids, each step of the port from comic_tpu's state of that step, so that
    every row compares one step's roundings. comic_tpu runs image by image
    (XLA's CPU runtime refuses its batched bf16 context product for a batch
    above 1, test_torch_attention.py), the port the B images in one batch.

    The cell's new c and h (float32) agree within TOL of their scale. The
    step rounds h to bfloat16 for the query and output projections; on
    every row whose rounded h is the same in both packages, the logits and
    the alignments agree within TOL of theirs. A row whose float32 h values
    straddle a bf16 rounding boundary (an ulp of summation order) takes the
    neighbouring bf16 value in one package, ~1e-3 of the logits' scale:
    such rows are counted, and at most one row in ten may be one."""
    cfg_j, cfg_t, pj, pt, rng, im_embed, fmap = setup
    ids = rng.integers(0, cfg_t.softmax_size - 2, (STEPS, B * K))
    ids[0] = cfg_t.softmax_size - 2
    im_k = np.repeat(im_embed, K, axis=0)
    bf16 = jnp.bfloat16
    mem_j = [jatt.precompute(pj["attention"], cfg_j.attention,
                             jnp.asarray(fmap[i: i + 1]), dtype=bf16)
             for i in range(B)]
    state_j = [jdec.initial_state(pj, cfg_j, jnp.asarray(im_k[i * K:
                                                              (i + 1) * K]),
                                  dtype=bf16) for i in range(B)]
    jstep = jax.jit(lambda p, i, s, m: jdec.step_grouped(
        p, cfg_j, jdec.embed_ids(p, cfg_j, i, dtype=bf16), s, m, K,
        dtype=bf16))

    def both(states):
        """comic_tpu's per-image states -> one (c, h, context) array each
        over the B * K rows."""
        return [np.concatenate([np.asarray(x, np.float32) for x in xs])
                for xs in zip(*[(s.cell_state.c, s.cell_state.h, s.attention)
                                for s in states])]

    flipped = 0
    with torch.no_grad():
        mem_t = tatt.precompute(pt["attention"], cfg_t.attention,
                                torch.from_numpy(fmap), dtype=torch.bfloat16)
        for t in range(STEPS):
            c, h, ctx = (torch.from_numpy(x) for x in both(state_j))
            state_t = tdec.DecoderState(LSTMState(c, h), ctx)
            outs = [jstep(pj, ids[t, i * K: (i + 1) * K], state_j[i],
                          mem_j[i]) for i in range(B)]
            state_j = [o[2] for o in outs]
            wv_t = tdec.embed_ids(pt, cfg_t, torch.from_numpy(ids[t]),
                                  dtype=torch.bfloat16)
            logits_t, align_t, state_t = tdec.step_grouped(
                pt, cfg_t, wv_t, state_t, mem_t, K, dtype=torch.bfloat16)
            c_j, h_j, _ = both(state_j)
            every = np.ones(B * K, bool)
            _rows_close(state_t.cell_state.c, c_j, every, f"c {t}")
            _rows_close(state_t.cell_state.h, h_j, every, f"h {t}")
            same = np.all(np.asarray(jnp.asarray(h_j).astype(bf16),
                                     np.float32)
                          == state_t.cell_state.h.to(torch.bfloat16)
                          .float().numpy(), axis=1)
            flipped += int((~same).sum())
            _rows_close(logits_t, np.concatenate(
                [np.asarray(o[0]) for o in outs]), same, f"logits {t}")
            _rows_close(align_t.reshape(B * K, -1), np.concatenate(
                [np.asarray(o[1]).reshape(K, -1) for o in outs]), same,
                f"alignments {t}")
    assert flipped <= STEPS * B * K // 10, flipped
