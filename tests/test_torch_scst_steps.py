"""The pieces of comic_tpu_torch's SCST step against comic_tpu's on the CPU
at tests/test_scst.py's small sizes (radix 16, batch 4, LSTM 32, 2 heads,
64x64 images, float32): sampling with comic_tpu's own Gumbel draws, the
rollout (beam 3 and beam 7), and one reward-weighted train step from the
same hypotheses and rewards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.decoding import search as jsearch
from comic_tpu.evaluation.scorers import CaptionScorer as JScorer
from comic_tpu.models import captioner as jcap
from comic_tpu.training import scst as jscst
from comic_tpu.training.optimizer import build_optimizer
from comic_tpu.training.schedule import cosine_schedule as jcosine
from comic_tpu.training.xe import TrainState as JTrainState
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.decoding import search as tsearch
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import scst as tscst
from comic_tpu_torch.training.schedule import cosine_schedule
from comic_tpu_torch.training.xe import TrainState

torch.set_num_threads(1)

# tests/test_scst.py::_small_config, augment off
SMALL = dict(token_type="radix", radix_base=16, dataset_file_pattern="synth_{}",
             batch_size_train=4, scst_beam_size=3, max_epoch=1, rnn_size=32,
             rnn_word_size=16, attn_num_heads=2, compute_dtype="float32",
             cnn_input_size=(64, 64), lr_start=1e-3, lr_end=1e-5,
             dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
             freeze_scopes="encoder/cnn", rand_seed=0,
             cnn_input_augment=False)
# float32, the same operations summed in other orders
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_STEP = 1e-4  # one Adam step: loss and parameters, relative


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic vocabulary, comic_tpu's seeded parameters with the
    output projection spread (so beams end and no two candidates sit
    within float32 noise), and a batch of seeded images."""
    root, jvocab = make_synthetic_dataset(
        str(tmp_path_factory.mktemp("scst_steps") / "d"), num_train=4,
        num_valid=4, num_test=4)
    cfg = dict(SMALL, dataset_dir=root)
    jspec = jcap.build_model_spec(JConfig(**cfg), jvocab)
    p = jax.tree_util.tree_map(
        np.asarray, jcap.init_params(jax.random.PRNGKey(0), jspec))
    proj = p["decoder"]["output_projection"]
    proj["kernel"] = proj["kernel"] * 6
    proj["bias"] = np.where(np.arange(proj["bias"].shape[0])
                            == jspec.decoder.end_id, 1.5, 0.0
                            ).astype(np.float32)
    images = np.random.default_rng(0).integers(0, 256, (4, 256, 256, 3),
                                               dtype=np.uint8)
    return cfg, jvocab, Vocabulary(dict(jvocab.wtoi)), p, images


# --- sampling -------------------------------------------------------------

def test_categorical_is_argmax_of_gumbel_noise():
    """The identity the port's sampler rests on: jax.random.categorical(key,
    logp) == argmax(logp + jax.random.gumbel(key, logp.shape))."""
    logp = jax.nn.log_softmax(jax.random.normal(jax.random.PRNGKey(3),
                                                (64, 18)) * 3)
    for key in jax.random.split(jax.random.PRNGKey(4), 20):
        want = jax.random.categorical(key, logp, axis=-1)
        got = jnp.argmax(logp + jax.random.gumbel(key, logp.shape), axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _search_setup(seed=7):
    from test_torch_search import B, T, V, _specs
    from comic_tpu.models import attention as jatt
    from comic_tpu.models.decoder import decoder_init
    from comic_tpu_torch.models import attention as tatt

    jspec, tspec = _specs()
    p = jax.tree_util.tree_map(
        np.asarray, decoder_init(jax.random.PRNGKey(seed), jspec.decoder))
    p["output_projection"]["kernel"] = p["output_projection"]["kernel"] * 3
    rng = np.random.default_rng(seed)
    im = rng.normal(size=(B, 6)).astype(np.float32)
    fm = rng.normal(size=(B, 5, 8)).astype(np.float32)
    jmem = jatt.precompute(p["attention"], jspec.decoder.attention, fm)
    tp = bridge.from_jax_tree(p, "cpu")
    tmem = tatt.precompute(tp["attention"], tspec.decoder.attention,
                           torch.from_numpy(fm))
    return jspec, tspec, p, tp, im, jmem, tmem, B, T, V


@pytest.mark.parametrize("early_exit,collect", [(False, True),
                                                (True, False)])
def test_sampling_with_comic_tpu_noise_matches(early_exit, collect):
    """greedy_or_sample(sample=True) from comic_tpu's per-step keys, their
    Gumbel draws injected into the port: the same ids, lengths and
    log-probabilities."""
    jspec, tspec, p, tp, im, jmem, tmem, B, T, V = _search_setup()
    key = jax.random.PRNGKey(11)
    want = jsearch.greedy_or_sample_from_memory(
        p, jspec, im, jmem, max_steps=T, sample=True, rng=key,
        collect_alignments=collect, early_exit=early_exit)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (B, V)))
                      for k in jax.random.split(key, T)])
    got = tsearch.greedy_or_sample_from_memory(
        tp, tspec, torch.from_numpy(im), tmem, max_steps=T, sample=True,
        noise=torch.from_numpy(noise), collect_alignments=collect,
        early_exit=early_exit)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)
    np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, **TOL_F32)
    greedy = jsearch.greedy_or_sample_from_memory(
        p, jspec, im, jmem, max_steps=T, collect_alignments=False)
    assert not np.array_equal(np.asarray(greedy.ids), np.asarray(want.ids))


def test_sampling_from_a_generator_draws_the_softmax():
    """With a generator the port draws its own Gumbel noise: seeded draws
    repeat, and over many rows the tokens of the first step follow the
    softmax of its logits."""
    jspec, tspec, p, tp, im, jmem, tmem, B, T, V = _search_setup()
    rows = 4000
    idx = torch.arange(rows) % B
    mem = type(tmem)(*(None if x is None else x[idx] for x in tmem))
    im_t = torch.from_numpy(im)[idx]
    runs = [tsearch.greedy_or_sample_from_memory(
        tp, tspec, im_t, mem, max_steps=1, sample=True,
        generator=torch.Generator().manual_seed(5),
        collect_alignments=False) for _ in range(2)]
    assert torch.equal(runs[0].ids, runs[1].ids)
    first = runs[0].ids[:, 0]
    for b in range(B):
        logp = np.asarray(jax.nn.log_softmax(jsearch.decoder_step(
            p, jspec.decoder, jsearch.embed_ids(
                p, jspec.decoder, jnp.full((1,), jspec.decoder.start_id)),
            jsearch.initial_state(p, jspec.decoder, im[b:b + 1]),
            jax.tree_util.tree_map(lambda x: x[b:b + 1], jmem))[0][0]))
        freq = np.bincount(first[idx == b].numpy(), minlength=V) / (rows / B)
        np.testing.assert_allclose(freq, np.exp(logp), atol=0.05)


# --- the rollout and the train step ----------------------------------------

def _rollout_both(setup, beam):
    cfg, jvocab, tvocab, p, images = setup
    cfg = dict(cfg, scst_beam_size=beam)
    jc, tc = JConfig(**cfg), Config(**cfg)
    jspec = jcap.build_model_spec(jc, jvocab)
    tspec = tcap.build_model_spec(tc, tvocab)
    want = jscst.make_rollout(jspec, jc, jvocab)(
        p, jnp.asarray(images), jax.random.PRNGKey(1))
    got = tscst.make_rollout(tspec, tc, tvocab, "cpu")(
        bridge.from_jax_tree(p, "cpu"), images)
    return (jc, jspec, [np.asarray(x) for x in want]), (tc, tspec, got)


@pytest.mark.parametrize("beam", [3, 7])
def test_rollout_matches(setup, beam):
    """Greedy and all-beam ids exact, im_embed and fmaps to 1e-5; the
    encoder outputs carry no graph and are not inference tensors (the
    train step differentiates through their use)."""
    (jc, _, want), (tc, _, got) = _rollout_both(setup, beam)
    g_ids, b_ids, im_embed, fmaps = got
    steps = tscst.scst_decode_steps(tc, setup[2])
    assert steps == jscst.scst_decode_steps(jc, setup[1]) == 40
    assert tuple(b_ids.shape) == (beam, 4, steps)
    np.testing.assert_array_equal(g_ids.numpy(), want[0])
    np.testing.assert_array_equal(b_ids.numpy(), want[1])
    np.testing.assert_allclose(im_embed.numpy(), want[2], **TOL_F32)
    np.testing.assert_allclose(fmaps.numpy(), want[3], **TOL_F32)
    assert (want[1] == jc.radix_base + 1).any()  # some beams end
    for t in (im_embed, fmaps):
        assert t.grad_fn is None and not t.requires_grad
        assert not t.is_inference()


def test_train_step_matches(setup):
    """One reward-weighted step from the rollout's hypotheses (scored by
    comic_tpu, image-major) and seeded rewards: the losses and every
    updated parameter within 1e-4 relative of comic_tpu's; the frozen CNN
    is untouched and takes no gradient."""
    (jc, jspec, want), (tc, tspec, got) = _rollout_both(setup, 3)
    cfg, jvocab, _, p, _ = setup
    refs = [["a man riding a bike", "a dog on the beach"]] * 4
    width = jscst.hypo_width(jc, jvocab)
    hypo, _, _ = jscst.host_score_shard(
        want[0], want[1], refs, JScorer(None, {"ciderD": 1.0}), jc, jvocab,
        width)
    hypo = np.asarray(hypo)
    rewards = np.random.default_rng(2).normal(size=12).astype(np.float32)

    schedule = jcosine(jc.lr_start, jc.lr_end, 10)
    opt, mask = build_optimizer(p, schedule, freeze_scopes=jc.freeze_scopes,
                                adam_epsilon=jc.adam_epsilon)
    jstate = JTrainState(p, opt.init(p), jnp.asarray(0, jnp.int32))
    jstep = jscst.make_scst_train_step(jspec, jc, opt, mask)
    jstate, jm = jstep(jstate, jnp.asarray(want[2]), jnp.asarray(want[3]),
                       jnp.asarray(hypo), jnp.asarray(rewards),
                       jax.random.PRNGKey(2))

    tp = bridge.from_jax_tree(p, "cpu")
    cnn_before = tp["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"].clone()
    topt_ = topt.Optimizer(tp, cosine_schedule(tc.lr_start, tc.lr_end, 10),
                           freeze_scopes=tc.freeze_scopes,
                           adam_epsilon=tc.adam_epsilon)
    topt.set_trainable(tp, topt_.mask)
    tstep = tscst.make_scst_train_step(tspec, tc, "cpu")
    tstate, tm = tstep(TrainState(tp, topt_, 0), got[2], got[3], hypo,
                       rewards)
    assert tstate.step == 1 and set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=TOL_STEP, atol=1e-7, err_msg=k)
    assert abs(float(jm["scst_loss"])) > 1e-3
    cnn = tstate.params["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"]
    assert torch.equal(cnn, cnn_before) and cnn.grad is None
    final = bridge.to_jax_tree(tstate.params)
    for path, a in topt.tree_items(final):
        b = np.asarray(topt.tree_get(jstate.params, path))
        np.testing.assert_allclose(
            a, b, rtol=TOL_STEP, atol=TOL_STEP * float(np.abs(b).max()),
            err_msg=topt.path_string(path))


def test_scst_forward_gradients_match_jax_grad(setup):
    """captioner.scst_forward, the reward-weighted XE of whole images and
    their hypotheses: the loss and d loss / d param of every leaf against
    jax.grad of comic_tpu's, rewards of both signs, float32."""
    from test_torch_xe import _captions, _check_leaf

    cfg, jvocab, tvocab, p, _ = setup
    jspec = jcap.build_model_spec(JConfig(**cfg), jvocab)
    tspec = tcap.build_model_spec(Config(**cfg), tvocab)
    rng = np.random.default_rng(6)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    caps = _captions(rng, 2, 7, 18)
    rewards = np.asarray([0.8, -0.5], np.float32)

    def loss(params):
        return jcap.scst_forward(params, jspec, jnp.asarray(images),
                                 jnp.asarray(caps), jnp.asarray(rewards),
                                 rng=jax.random.PRNGKey(0))[0]

    lj, gj = jax.jit(jax.value_and_grad(loss))(p)
    pt = bridge.from_jax_tree(p, "cpu")
    mask = topt.trainable_mask(pt, "")
    topt.set_trainable(pt, mask)
    lt, aux = tcap.scst_forward(pt, tspec,
                                torch.from_numpy(images).permute(0, 3, 1, 2),
                                torch.from_numpy(caps), torch.from_numpy(rewards))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert abs(float(lj)) > 1e-3 and aux["log_ppl"] is lt
    grads = bridge.to_jax_tree(topt._map_paths(
        lambda path, v: v.grad if v.grad is not None
        else torch.zeros_like(v), pt))
    leaves = [(path, g) for path, g in topt.tree_items(grads)
              if topt.tree_get(mask, path)]
    assert len(leaves) > 100
    for path, g in leaves:
        _check_leaf(path, g, np.asarray(topt.tree_get(gj, path)), "float32")
