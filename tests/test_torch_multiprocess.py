"""The port's data parallelism in real 2-process torch.distributed jobs
(gloo, on the CPU), the counterpart of tests/test_multihost.py.

Two processes run tests/torch_multiprocess_worker.py (torch only) and join
one job from COMIC_COORDINATOR; each takes its block of a global batch of
4. Against comic_tpu's 2-device mesh steps at that global batch (this
process; tests/conftest.py gives 8 virtual devices), float32, dropout off,
the CNN frozen (the decoder stage): the XE step's loss within rtol 1e-5 and
its parameters within rtol 1e-4 / atol 1e-6 (test_parallel.py's
tolerances); the SCST rollout's ids exact, its rewards within rtol 1e-5,
its step's parameters as above. With nothing frozen and dropout, augment
and alignment dropout on, the port's 2-rank XE step equals its one-process
step at the global batch to the same tolerances on every leaf, the CNN's
included (the draws are taken at the global shape). The eval perplexity is
the global mean, split or replicated, and the TrainPipeline's rank blocks
concatenate to the one-process global batches.

A second job declares its two ranks ONE host (LOCAL_WORLD_SIZE=2), the
unit of a comic_tpu job: train_fn's XE step at batch_size_train 4 trains
the host's 4 rows (2 a rank), as comic_tpu's one process over two chips
does, and at batch 3 rank 0 trains all 3 while rank 1 idles with
comic_tpu's IDLE warning; the pipeline's max_step and steps_per_epoch are
comic_tpu's; an SCST step at batch 3 on that mesh gives comic_tpu's ids,
rewards and parameters. Same tolerances.
"""

import contextlib
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiprocess_worker as worker
from comic_tpu.configuration import Config as JConfig
from comic_tpu.data import pipeline as jpipe
from comic_tpu.evaluation.ngrams import build_idf_cache, save_idf_cache
from comic_tpu.evaluation.scorers import CaptionScorer as JScorer
from comic_tpu.models import captioner as jcap
from comic_tpu.parallel.mesh import make_mesh, make_mesh_for_batch, replicate
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.training import scst as jscst
from comic_tpu.training.optimizer import build_optimizer
from comic_tpu.training.schedule import cosine_schedule as jcosine
from comic_tpu.training.xe import TrainState as JTrainState
from comic_tpu.training.xe import make_train_step as jmake_train_step
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.data.pipeline import TrainPipeline
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import xe as txe
from comic_tpu_torch.training.checkpoints import save_compact
from comic_tpu_torch.training.schedule import cosine_schedule

torch.set_num_threads(1)

# 58 words: two radix-8 digits a word, and almost every pair is a word, so
# the rollout's captions hold words and the rewards are not all zero
WORDS = [f"w{i}" for i in range(58)]
WTOI = {"<PAD>": -1, **{w: i for i, w in enumerate(WORDS)},
        "<UNK>": 58, "<GO>": 59, "<EOS>": 60}
# tests/test_parallel.py::_tiny_setup with a 58-word vocabulary
BASE = dict(token_type="radix", radix_base=8, rnn_size=16, rnn_word_size=8,
            attn_num_heads=2, compute_dtype="float32",
            cnn_input_size=(64, 64), dropout_rnn_in=0.0, dropout_rnn_out=0.0,
            attn_keep_prob=1.0, freeze_scopes="encoder/cnn",
            cnn_input_augment=False, infer_beam_size=3, infer_max_length=4,
            scst_beam_size=2, batch_size_train=4)
SPECS = {
    "xe_off": BASE,
    # nothing frozen: the CNN's gradients are summed over the ranks too
    "xe_drop": dict(BASE, dropout_rnn_in=0.3, dropout_rnn_out=0.3,
                    attn_keep_prob=0.8, cnn_input_augment=True,
                    freeze_scopes=""),
    "scst": BASE,
    "pipeline": dict(BASE, batch_size_train=2, max_epoch=1),
}
# the one-host job's configuration (train_fn reads the vocabulary from it)
HOST = dict(BASE, batch_size_eval=4, wtoi=WTOI, itow={
    str(k): w for k, w in Vocabulary(dict(WTOI)).itow.items()})
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _records(n, first=0):
    rng = np.random.default_rng([7, first])
    return [(f"{first + i}.jpg",
             ["<GO>"] + [WORDS[w] for w in rng.integers(
                 0, 58, int(rng.integers(2, 9)))] + ["<EOS>"])
            for i in range(n)]


def _inputs(work):
    """The job's parameters, images, captions and references, also written
    into ``work`` for the workers."""
    tspec = tcap.build_model_spec(Config(**BASE), Vocabulary(dict(WTOI)))
    tree = bridge.to_jax_tree(tcap.init_params(
        tspec, torch.Generator().manual_seed(0), device="cpu"))
    # spread the output projection so no two candidates sit within
    # float32 noise (tests/test_torch_scst_steps.py)
    proj = tree["decoder"]["output_projection"]
    proj["kernel"] = proj["kernel"] * 6
    proj["bias"] = np.zeros_like(proj["bias"])
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    caps = np.full((4, 8), -1, np.int32)
    for i, n in enumerate((3, 6, 2, 5)):
        caps[i, 0] = tspec.decoder.start_id
        caps[i, 1:n] = rng.integers(0, 8, n - 1)
        caps[i, n] = tspec.decoder.end_id
    refs = [[" ".join(WORDS[w] for w in rng.integers(40, 50, 5))
             for _ in range(2)] for _ in range(4)]
    save_idf_cache(str(work / "idf.p"), build_idf_cache(refs))
    np.savez(work / "params.npz", **worker.flat_params(tree))
    np.savez(work / "inputs.npz", images=images, caps=caps)
    with open(work / "spec.json", "w") as f:
        json.dump({"wtoi": WTOI, "refs": refs, "records": _records(12),
                   "valid": _records(12, 100), "host": HOST, **SPECS}, f)
    return tree, images, caps, refs


def _run_with(mode, work, references, env=None):
    """The job's ranks' results and ``references()``, computed while the
    job runs."""
    results = {}

    def run():
        try:
            results["ranks"] = worker.run_job(mode, work, timeout=150,
                                              env=env)
        except BaseException as e:  # re-raised below
            results["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        ref = references()
    finally:
        thread.join()
    if "error" in results:
        raise results["error"]
    return results["ranks"], ref


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs, the 2-process job's results (one per rank) and the
    one-process references of both packages, computed while the job
    runs."""
    work = tmp_path_factory.mktemp("dp_job")
    tree, images, caps, refs = _inputs(work)
    return _run_with("steps", work, lambda: _references(
        tree, images, caps, refs, str(work / "idf.p")))


def _jax_state(mesh, tree, c):
    opt, mask = build_optimizer(tree, jcosine(1e-3, 1e-4, 10),
                                freeze_scopes=c.freeze_scopes,
                                adam_epsilon=c.adam_epsilon)
    return (JTrainState(replicate(mesh, tree), replicate(mesh, opt.init(tree)),
                        jnp.asarray(0, jnp.int32)), opt, mask)


def _references(tree, images, caps, refs, idf):
    """comic_tpu's 2-device mesh steps and the port's one-process steps."""
    out = {}
    mesh = make_mesh(2)
    jvocab = JVocabulary(dict(WTOI))
    c = JConfig(**BASE)
    jspec = jcap.build_model_spec(c, jvocab)
    state, opt, mask = _jax_state(mesh, tree, c)
    step = jmake_train_step(jspec, c, opt, mask, (64, 64), mesh=mesh)
    state, m = step(state, images, caps, jax.random.PRNGKey(7))
    out["xe_off"] = (float(m["total_loss"]), float(m["map_loss"]),
                     jax.tree_util.tree_map(np.asarray, state.params))

    state, opt, mask = _jax_state(mesh, tree, c)
    rollout = jscst.make_rollout(jspec, c, jvocab, mesh=mesh)
    greedy, beams, im_embed, fmaps = rollout(state.params, images,
                                             jax.random.PRNGKey(3))
    width = jscst.hypo_width(c, jvocab)
    hypo, rewards, _ = jscst.host_score_shard(
        greedy, beams, refs, JScorer(idf, {"ciderD": 1.0}), c, jvocab,
        width, mesh=mesh)
    step = jscst.make_scst_train_step(jspec, c, opt, mask, mesh=mesh)
    state, m = step(state, im_embed, fmaps, hypo, rewards,
                    jax.random.PRNGKey(4))
    out["scst"] = (float(m["total_loss"]), float(m["map_loss"]),
                   jax.tree_util.tree_map(np.asarray, state.params))
    out["rollout"] = [np.asarray(x) for x in (greedy, beams, hypo, rewards)]

    # the port in one process at the global batch, dropout on
    vocab = Vocabulary(dict(WTOI))
    config = Config(**SPECS["xe_drop"])
    spec = tcap.build_model_spec(config, vocab)
    tp = bridge.from_jax_tree(tree, "cpu")
    topt_ = topt.Optimizer(tp, cosine_schedule(1e-3, 1e-4, 10),
                           freeze_scopes=config.freeze_scopes,
                           adam_epsilon=config.adam_epsilon)
    topt.set_trainable(tp, topt_.mask)
    tstate, tm = txe.make_train_step(spec, config, (64, 64), "cpu")(
        txe.TrainState(tp, topt_, 0), images, caps,
        torch.Generator().manual_seed(5))
    out["xe_drop"] = (float(tm["total_loss"]), float(tm["map_loss"]),
                      bridge.to_jax_tree(tstate.params))

    config = Config(**BASE)
    eval_step = txe.make_eval_step(spec, config, (64, 64), "cpu")
    tp = bridge.from_jax_tree(tree, "cpu")
    for batch in (4, 3):
        config.batch_size_eval = batch
        pipe = TrainPipeline(config, vocab, "valid", records=_records(12, 100),
                             loader=worker._EvalImages(images))
        out[f"eval_ppl_{batch}"] = txe.evaluate_perplexity(eval_step, tp,
                                                           pipe)
        pipe.close()

    config = Config(**dict(SPECS["pipeline"], batch_size_train=4))
    pipe = TrainPipeline(config, vocab, "train", records=_records(12),
                         loader=worker.IndexImages())
    it = iter(pipe)
    out["pipeline"] = ([next(it) for _ in range(pipe.steps_per_epoch)],
                       config.max_step, pipe.steps_per_epoch)
    pipe.close()
    return out


def _params_close(got, want):
    flat = worker.flat_params(want)
    assert set(got) == set(flat)
    for k, w in flat.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **PARAM_TOL)


def _rank_params(rank, tag):
    prefix = f"{tag}/params/"
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def test_the_job_is_two_gloo_ranks_with_one_all_reduce_a_step(job):
    ranks, _ = job
    for r in ranks:
        assert str(r["backend"]) == "gloo" and int(r["world"]) == 2
        # xe_off, xe_drop and the SCST step
        assert int(r["all_reduce_calls"]) == 3


@pytest.mark.parametrize("tag", ["xe_off", "xe_drop", "scst"])
def test_ranks_hold_equal_parameters(job, tag):
    ranks, _ = job
    a, b = (_rank_params(r, tag) for r in ranks)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("tag", ["xe_off", "scst"])
def test_step_matches_comic_tpu_two_device_mesh(job, tag):
    """The 2-rank step equals comic_tpu's 2-device mesh step at the global
    batch: the loss, the map loss and every updated parameter."""
    ranks, ref = job
    total, map_loss, params = ref[tag]
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}/loss"], [total, map_loss],
                                   **LOSS_TOL)
    assert abs(map_loss) > 1e-6  # the map loss is on (global rows)
    _params_close(_rank_params(ranks[0], tag), params)


def test_two_rank_step_with_dropout_equals_one_rank_global_step(job):
    ranks, ref = job
    total, map_loss, params = ref["xe_drop"]
    np.testing.assert_allclose(ranks[0]["xe_drop/loss"], [total, map_loss],
                               **LOSS_TOL)
    _params_close(_rank_params(ranks[0], "xe_drop"), params)
    # dropout changed the step
    assert not np.allclose(ranks[0]["xe_drop/loss"], ranks[0]["xe_off/loss"])


def test_scst_rollout_and_rewards_match_comic_tpu_mesh(job):
    """Each rank's block of the greedy and beam ids (exact), of the
    image-major hypotheses (exact) and of the rewards (rtol 1e-5)."""
    ranks, ref = job
    greedy, beams, hypo, rewards = ref["rollout"]
    k = BASE["scst_beam_size"]
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["scst/greedy"],
                                      greedy[2 * i: 2 * i + 2])
        np.testing.assert_array_equal(r["scst/beams"],
                                      beams[:, 2 * i: 2 * i + 2])
        np.testing.assert_array_equal(r["scst/hypo"],
                                      hypo[2 * k * i: 2 * k * (i + 1)])
        np.testing.assert_allclose(r["scst/rewards"],
                                   rewards[2 * k * i: 2 * k * (i + 1)],
                                   rtol=1e-5)
    assert np.abs(rewards).max() > 1e-3


@pytest.mark.parametrize("batch", [4, 3])
def test_eval_perplexity_is_the_global_mean(job, batch):
    """Batch 4 splits over the ranks (one all_reduce at the end), batch 3
    is scored whole on each rank; both equal the one-process pass."""
    ranks, ref = job
    for r in ranks:
        np.testing.assert_allclose(float(r[f"eval_ppl_{batch}"]),
                                   ref[f"eval_ppl_{batch}"], rtol=1e-5)


def test_pipeline_blocks_concatenate_to_the_global_batches(job):
    """Each rank's block of every global batch, with the global batch's
    width; max_step and steps_per_epoch count global batches."""
    ranks, ref = job
    batches, max_step, steps = ref["pipeline"]
    assert steps == 3 and max_step == 3
    for r in ranks:
        assert list(r["pipe/counts"]) == [max_step, steps]
    for i, (images, caps) in enumerate(batches):
        np.testing.assert_array_equal(np.concatenate(
            [r[f"pipe/images/{i}"] for r in ranks]), images)
        np.testing.assert_array_equal(np.concatenate(
            [r[f"pipe/caps/{i}"] for r in ranks]), caps)


# --- one host of two ranks (fault F1: a job's unit is the host) -------------

def _host_references(tree, images, refs, idf):
    """comic_tpu's one process on a host of two chips (make_mesh_for_batch
    capped at 2): the XE step at the first global batch of 4 and of 3, its
    pipeline's counts and its printed warning; the SCST rollout, scoring
    and step at batch 3."""
    out = {}
    vocab, jvocab = Vocabulary(dict(WTOI)), JVocabulary(dict(WTOI))
    for batch in (4, 3):
        c = JConfig(**dict(HOST, batch_size_train=batch))
        jp = jpipe.TrainPipeline(c, jvocab, "train", records=_records(12))
        counts = (c.max_step, jp.steps_per_epoch)
        jp.loader.close()
        # the first global batch: the port's one-process pipeline, whose
        # batches are comic_tpu's (test_torch_train_data.py)
        tp = TrainPipeline(Config(**dict(HOST, batch_size_train=batch)),
                           vocab, "train", records=_records(12),
                           loader=worker._EvalImages(images))
        batch_images, batch_caps = next(iter(tp))
        tp.close()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            mesh = make_mesh_for_batch(batch, limit=2)
        jspec = jcap.build_model_spec(c, jvocab)
        opt, mask = build_optimizer(
            tree, jcosine(c.lr_start, c.lr_end, 1), optimiser=c.optimiser,
            adam_epsilon=c.adam_epsilon, freeze_scopes=c.freeze_scopes,
            cnn_grad_multiplier=c.cnn_grad_multiplier,
            clip_gradient_norm=c.clip_gradient_norm)
        state = JTrainState(replicate(mesh, tree),
                            replicate(mesh, opt.init(tree)),
                            jnp.asarray(0, jnp.int32))
        step = jmake_train_step(jspec, c, opt, mask, (64, 64), mesh=mesh)
        state, m = step(state, batch_images, batch_caps,
                        jax.random.PRNGKey(7))
        out[f"xe{batch}"] = dict(
            loss=[float(m["total_loss"]), float(m["map_loss"])],
            params=jax.tree_util.tree_map(np.asarray, state.params),
            counts=counts, devices=mesh.devices.size, log=log.getvalue())

    c = JConfig(**dict(HOST, batch_size_train=3))
    jspec = jcap.build_model_spec(c, jvocab)
    with contextlib.redirect_stdout(io.StringIO()):
        mesh = make_mesh_for_batch(3, limit=2)
    state, opt, mask = _jax_state(mesh, tree, c)
    greedy, beams, im_embed, fmaps = jscst.make_rollout(
        jspec, c, jvocab, mesh=mesh)(state.params, images[:3],
                                     jax.random.PRNGKey(3))
    hypo, rewards, _ = jscst.host_score_shard(
        greedy, beams, refs[:3], JScorer(idf, {"ciderD": 1.0}), c, jvocab,
        jscst.hypo_width(c, jvocab), mesh=mesh)
    state, m = jscst.make_scst_train_step(jspec, c, opt, mask, mesh=mesh)(
        state, im_embed, fmaps, hypo, rewards, jax.random.PRNGKey(4))
    out["scst3"] = dict(
        ids=[np.asarray(x) for x in (greedy, beams, hypo)],
        rewards=np.asarray(rewards),
        loss=[float(m["total_loss"]), float(m["map_loss"])],
        params=jax.tree_util.tree_map(np.asarray, state.params))
    return out


@pytest.fixture(scope="module")
def host_job(tmp_path_factory):
    """A 2-process job declared as one host of two ranks: the ranks'
    results and comic_tpu's one-process references."""
    work = tmp_path_factory.mktemp("host_job")
    tree, images, _, refs = _inputs(work)
    save_compact(str(work / "init"), 0, bridge.from_jax_tree(tree, "cpu"))
    return _run_with("host", work, lambda: _host_references(
        tree, images, refs, str(work / "idf.p")),
        env={"LOCAL_WORLD_SIZE": "2"})


@pytest.mark.parametrize("batch", [4, 3])
def test_one_host_xe_step_trains_the_hosts_batch(host_job, batch):
    """train_fn's step in a job of one host of two ranks equals comic_tpu's
    step over a host of two chips at the global batch batch_size_train
    (not batch_size_train a rank): at 4 each rank takes 2 rows, at 3 rank
    0 takes every row and rank 1 none; every rank ends with comic_tpu's
    parameters."""
    ranks, ref = host_job
    want = ref[f"xe{batch}"]
    assert [int(r[f"xe{batch}/rows"]) for r in ranks] == (
        [2, 2] if batch == 4 else [3, 0])
    for r in ranks:
        assert list(r["hosts"]) == [2, 1]  # ranks a host, hosts
        np.testing.assert_allclose(r[f"xe{batch}/loss"], want["loss"],
                                   **LOSS_TOL)
        _params_close(_rank_params(r, f"xe{batch}"), want["params"])


@pytest.mark.parametrize("batch", [4, 3])
def test_one_host_pipeline_counts_comic_tpus_steps(host_job, batch):
    """max_step and steps_per_epoch count the host's global batches, equal
    to comic_tpu's for the same job."""
    ranks, ref = host_job
    for r in ranks:
        assert tuple(r[f"xe{batch}/counts"]) == ref[f"xe{batch}"]["counts"]


def test_one_host_idle_rank_is_warned_as_in_comic_tpu(host_job):
    """Batch 3 on a host of two: comic_tpu uses one chip and prints its
    IDLE warning; the port's rank 0 prints the same line, rank 1 idles
    silently, and batch 4 warns nowhere."""
    ranks, ref = host_job
    assert (ref["xe4"]["devices"], ref["xe3"]["devices"]) == (2, 1)
    warning = ref["xe3"]["log"].strip()
    assert "1 device IDLE" in warning and "IDLE" not in ref["xe4"]["log"]
    assert warning in str(ranks[0]["xe3/log"])
    assert warning in str(ranks[0]["scst3/log"])
    for r in ranks:
        assert "IDLE" not in str(r["xe4/log"])
    assert "IDLE" not in str(ranks[1]["xe3/log"])


def test_one_host_scst_with_an_idle_rank_matches_comic_tpu(host_job):
    """SCST at batch 3 on a host of two: rank 0's rollout ids and
    hypotheses are comic_tpu's exactly and its rewards within rtol 1e-5;
    rank 1's blocks are empty; both ranks' loss and parameters are
    comic_tpu's."""
    ranks, ref = host_job
    want = ref["scst3"]
    r0, r1 = ranks
    for key, ids in zip(("greedy", "beams", "hypo"), want["ids"]):
        np.testing.assert_array_equal(r0[f"scst3/{key}"], ids, err_msg=key)
    np.testing.assert_allclose(r0["scst3/rewards"], want["rewards"],
                               rtol=1e-5)
    assert np.abs(want["rewards"]).max() > 1e-3
    assert r1["scst3/greedy"].shape[0] == r1["scst3/hypo"].shape[0] == 0
    assert r1["scst3/beams"].shape[1] == r1["scst3/rewards"].shape[0] == 0
    for r in ranks:
        np.testing.assert_allclose(r["scst3/loss"], want["loss"], **LOSS_TOL)
        _params_close(_rank_params(r, "scst3"), want["params"])
