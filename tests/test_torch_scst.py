"""comic_tpu_torch's SCST stage against comic_tpu's on the CPU: the decode
budget, the host scoring and its image-major reorder, the two regressions
of tests/test_scst.py (numeric key order beyond ten images, hypotheses
paired with their image's encoder rows), both drivers over 3 steps from
one compact checkpoint with the overlap schedule on and off, and the
training CLI's scst stage."""

import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from comic_tpu.cli import train as jcli
from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.evaluation.scorers import CaptionScorer as JScorer
from comic_tpu.models import captioner as jcap
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.training import checkpoints as jckpt
from comic_tpu.training import scst as jscst
from comic_tpu_torch import params as bridge
from comic_tpu_torch.cli import train as tcli
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.data import captions as tcap_io
from comic_tpu_torch.data.pipeline import ScstPipeline
from comic_tpu_torch.evaluation.ngrams import build_idf_cache, save_idf_cache
from comic_tpu_torch.evaluation.scorers import CaptionScorer
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import scst as tscst
from test_torch_native_ciderd import (  # noqa: F401 (fixtures)
    assert_both_native, ciderd_used, native_ciderd)

torch.set_num_threads(1)

WTOI = {"<PAD>": -1, "a": 0, "cat": 1, "sat": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}


def test_decode_budget_matches():
    wtoi = {"<PAD>": -1, "<UNK>": 0, "<GO>": 1, "<EOS>": 2}
    wtoi.update({f"w{i}": i + 3 for i in range(290)})
    for kw in (dict(token_type="radix", radix_base=16),
               dict(token_type="radix", radix_base=256),
               dict(token_type="word"), dict(token_type="char")):
        want = (jscst.scst_decode_steps(JConfig(**kw), JVocabulary(wtoi)),
                jscst.hypo_width(JConfig(**kw), JVocabulary(wtoi)))
        got = (tscst.scst_decode_steps(Config(**kw), Vocabulary(wtoi)),
               tscst.hypo_width(Config(**kw), Vocabulary(wtoi)))
        assert got == want
    assert got == (100, 102)  # char: 20 words x 5


def _word_case():
    refs = [["a cat sat"], ["a cat"]]
    greedy = np.asarray([[0, 1, 5], [0, 5, -1]])
    # beam-major decoded ids: beam k, image i
    beam = np.asarray([
        [[0, 1, 2, 5], [0, 1, 5, -1]],   # beam 0: im0 "a cat sat", im1 "a cat"
        [[2, 2, 5, -1], [1, 5, -1, -1]],  # beam 1: im0 "sat sat",   im1 "cat"
    ])
    return refs, greedy, beam


def test_score_and_encode_matches(ciderd_used):
    refs, greedy, beam = _word_case()
    got = tscst.score_and_encode(
        CaptionScorer(None, {"ciderD": 1.0, "bleu": [0, 0, 0, 2]}),
        Config(token_type="word"), Vocabulary(dict(WTOI)), refs, greedy,
        beam, width=6)
    want = jscst.score_and_encode(
        JScorer(None, {"ciderD": 1.0, "bleu": [0, 0, 0, 2]}),
        JConfig(token_type="word"), JVocabulary(dict(WTOI)), refs, greedy,
        beam, width=6)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0][0], [4, 0, 1, 2, 5, -1])
    assert got[1][0] > got[1][2]  # the exact reference scores highest
    assert_both_native(ciderd_used)


def test_scores_keep_numeric_order_beyond_ten_images(tmp_path):
    """The joint gts/res dict is split back into greedy and sample blocks
    by NUMERIC key position; a lexicographic sort (0,1,10,11,...,2,...)
    would scramble the rewards once it holds 10 keys or more (batch 10 x
    beam 7 holds 80). With a fixed IDF cache CIDEr-D is per image, so
    every score must equal that image's score alone."""
    words = [f"w{i}" for i in range(10)]
    b = 12
    refs = [[" ".join(words[(i + j) % 10] for j in range(5))]
            for i in range(b)]
    hypos = [" ".join(words[(i * 3 + j) % 10] for j in range(4))
             for i in range(b)]
    greedy = [" ".join(words[(i + j) % 10] for j in range(3))
              for i in range(b)]
    path = str(tmp_path / "idf.p")
    save_idf_cache(path, build_idf_cache(refs))
    scorer = CaptionScorer(path, {"ciderD": 1.0})
    assert scorer.ciderd_impl == "native"
    _, s_all, g_all = scorer.get_hypo_scores(
        refs, [[h] for h in hypos], [[g] for g in greedy])
    for i in range(b):
        _, s_one, g_one = scorer.get_hypo_scores(
            [refs[i]], [[hypos[i]]], [[greedy[i]]])
        np.testing.assert_allclose(s_all[i], s_one[0], rtol=1e-9,
                                   err_msg=f"sample score image {i}")
        np.testing.assert_allclose(g_all[i], g_one[0], rtol=1e-9,
                                   err_msg=f"greedy score image {i}")
    assert len(set(np.round(s_all, 9))) > 3  # the images do score apart


def test_hypotheses_reach_train_step_image_major(ciderd_used):
    """The scorer works beam-major (row k*B + i) but the train step
    repeats encoder outputs IMAGE-major (row i*K + k, repeat_interleave):
    _finish_step must pair hypothesis (image i, beam k) with image i's
    encoder row, as comic_tpu's does."""
    refs, greedy, beam = _word_case()
    captured = {}

    def fake_train_step(state, im_embed, fmaps, hypo_ids, rewards,
                        generator):
        captured["hypo"], captured["rewards"] = hypo_ids, rewards
        return state, {"total_loss": torch.zeros(())}

    pending = ((torch.from_numpy(greedy), torch.from_numpy(beam),
                torch.zeros(2, 4), torch.zeros(2, 3, 4)), refs)
    _, metrics, step = tscst._finish_step(
        pending, None, fake_train_step, CaptionScorer(None, {"ciderD": 1.0}),
        Config(token_type="word", scst_beam_size=2), Vocabulary(dict(WTOI)),
        6, None, 0)
    assert step == 1 and "reward" in metrics
    hypo = captured["hypo"]
    np.testing.assert_array_equal(hypo[0], [4, 0, 1, 2, 5, -1])  # im0 b0
    np.testing.assert_array_equal(hypo[1], [4, 2, 2, 5, -1, -1])  # im0 b1
    np.testing.assert_array_equal(hypo[2], [4, 0, 1, 5, -1, -1])  # im1 b0
    np.testing.assert_array_equal(hypo[3], [4, 1, 5, -1, -1, -1])  # im1 b1
    assert captured["rewards"][0] > captured["rewards"][1]
    # comic_tpu's reorder gives the same rows and rewards
    want = jscst.host_score_shard(
        greedy, beam, refs, JScorer(None, {"ciderD": 1.0}),
        JConfig(token_type="word", scst_beam_size=2),
        JVocabulary(dict(WTOI)), 6)
    np.testing.assert_array_equal(hypo, np.asarray(want[0]))
    np.testing.assert_array_equal(captured["rewards"], np.asarray(want[1]))
    assert_both_native(ciderd_used)
    # the train step repeats the encoder rows image-major
    rows = torch.arange(2.0)[:, None]
    assert rows.repeat_interleave(2, dim=0)[:, 0].tolist() == [0, 0, 1, 1]


def test_scst_pipeline_matches(tmp_path):
    """Batches of (images, per-image references) in comic_tpu's order:
    grouped by image, no bucketing, the remainder dropped; the config's
    split size and max_step as comic_tpu sets them."""
    from comic_tpu.data.pipeline import ScstPipeline as JScstPipeline

    root, vocab = make_synthetic_dataset(str(tmp_path / "d"), num_train=10,
                                         num_valid=2, num_test=2)
    kw = dict(dataset_dir=root, dataset_file_pattern="synth_{}",
              batch_size_train=4, max_epoch=3, rand_seed=3)
    jc, tc = JConfig(**kw), Config(**kw)
    jp = JScstPipeline(jc, vocab, num_workers=1)
    tp = ScstPipeline(tc, Vocabulary(dict(vocab.wtoi)), num_workers=1)
    assert (tc.split_sizes, tc.max_step) == (jc.split_sizes, jc.max_step) \
        == ({"train": 10}, 7)
    assert tp.records == jp.records
    assert all(len(refs) == 2 for _, refs in tp.records)
    jit, tit = iter(jp), iter(tp)
    for _ in range(5):  # two epochs of 2 batches, then the third's first
        (ji, jr), (ti, tr) = next(jit), next(tit)
        assert tr == jr and ti.shape == (4, 256, 256, 3)
        np.testing.assert_array_equal(ti, ji)
    tit.close()
    tp.close()


# --- the drivers ------------------------------------------------------------

DRIVER = dict(token_type="radix", radix_base=16,
              dataset_file_pattern="synth_{}", batch_size_train=4,
              scst_beam_size=3, max_epoch=1, rnn_size=32, rnn_word_size=16,
              attn_num_heads=2, compute_dtype="float32",
              cnn_input_size=(64, 64), lr_start=1e-3, lr_end=1e-5,
              dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
              cnn_input_augment=False, freeze_scopes="encoder/cnn",
              rand_seed=0, num_data_shards=1)
# 3 SCST steps in f32 from one checkpoint: the same hypotheses, the losses
# summed in other orders, carried by 3 Adam steps
DRIVER_RTOL = 1e-4


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """comic_tpu's and the port's train_fn_scst, 3 steps each from one
    compact checkpoint (output projection spread, so that captions hold
    words), overlap on and off, on 16 synthetic images with an IDF cache
    of their references -> (root, {(package, overlap): (metrics, dir)})."""
    root = tmp_path_factory.mktemp("scst")
    data, vocab = make_synthetic_dataset(
        str(root / "data"), num_train=16, num_valid=4, num_test=4)
    refs = tcap_io.group_by_image(tcap_io.read_caption_file(
        os.path.join(data, "captions", "synth_train.txt")))
    save_idf_cache(os.path.join(data, "captions", "synth_scst-words.p"),
                   build_idf_cache([r for _, r in refs]))
    jspec = jcap.build_model_spec(JConfig(**DRIVER), vocab)
    init = jax.tree_util.tree_map(
        np.asarray, jcap.init_params(jax.random.PRNGKey(5), jspec))
    # spread the logits and favour the leading digits 0 and 1, so that the
    # digit pairs decode to some of the 29 words, and EOS
    proj = init["decoder"]["output_projection"]
    proj["kernel"] = proj["kernel"] * 3
    proj["bias"] = np.where(np.arange(proj["bias"].shape[0])
                            == jspec.decoder.end_id, 0.5, 0.0
                            ).astype(np.float32)
    proj["bias"][:2] = 2.0
    start = str(root / "start")
    jckpt.save_checkpoint(start, 1, init)
    out = {}
    for overlap in (True, False):
        for name in ("jax", "port"):
            log = str(root / f"{name}_{overlap}")
            kw = dict(DRIVER, dataset_dir=data, checkpoint_path=start,
                      log_path=log, scst_overlap=overlap)
            if name == "jax":
                m = jscst.train_fn_scst(JConfig(**kw), max_steps_override=3)
            else:
                m = tscst.train_fn_scst(Config(**kw), max_steps_override=3,
                                        device="cpu")
            out[name, overlap] = (m, log)
    return root, out


def _final_params(d):
    with open(os.path.join(d, "model_compact-3.msgpack"), "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.mark.parametrize("overlap", [True, False])
def test_drivers_agree(drivers, overlap):
    """The last step's metrics and the final parameters within 1e-4; the
    checkpoints at step 3 only (the overlap schedule trains exactly
    max_step steps); rewards that are not all zero."""
    _, out = drivers
    (jm, jdir), (tm, tdir) = out["jax", overlap], out["port", overlap]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=DRIVER_RTOL, atol=1e-6,
                                   err_msg=k)
    assert jm["score_sample"] > 0 and jm["reward"] != 0
    for d in (jdir, tdir):
        assert sorted(f for f in os.listdir(d) if f.endswith(".msgpack")) \
            == ["model-3.msgpack", "model_compact-3.msgpack"]
    want = _final_params(jdir)
    got = bridge.to_jax_tree(tckpt.load_compact(
        tdir, bridge.from_jax_tree(want, "cpu")))
    for path, a in topt.tree_items(got):
        b = np.asarray(topt.tree_get(want, path))
        np.testing.assert_allclose(
            a, b, rtol=DRIVER_RTOL,
            atol=DRIVER_RTOL * float(np.abs(b).max()),
            err_msg=topt.path_string(path))
    with open(os.path.join(tdir, "config.pkl"), "rb") as f:
        assert pickle.load(f)["scst_overlap"] is overlap


def test_overlap_changes_the_run(drivers):
    """The two schedules train on hypotheses of different parameters from
    step 2 on, in both packages alike."""
    _, out = drivers
    for name in ("jax", "port"):
        a = _final_params(out[name, True][1])["decoder"]["output_projection"]
        b = _final_params(out[name, False][1])["decoder"]["output_projection"]
        assert not np.array_equal(a["kernel"], b["kernel"])


def test_full_checkpoint_resumes_in_comic_tpu(drivers):
    """The port's full SCST checkpoint (params, optimizer state, step)
    restores in comic_tpu with the SCST optimizer chain."""
    _, out = drivers
    tdir = out["port", True][1]
    from comic_tpu.configuration import load_config
    from comic_tpu.training.optimizer import build_optimizer
    from comic_tpu.training.schedule import cosine_schedule

    cfg = load_config(tdir)
    spec = jcap.build_model_spec(cfg, JVocabulary.from_str_itow(cfg.wtoi,
                                                                cfg.itow))
    params = jcap.init_params(jax.random.PRNGKey(0), spec)
    opt, _ = build_optimizer(params, cosine_schedule(1e-3, 1e-5, 3),
                             freeze_scopes=cfg.freeze_scopes,
                             adam_epsilon=cfg.adam_epsilon)
    _, _, step, mode = jckpt.restore_model(params, tdir, resume=True,
                                           opt_state=opt.init(params))
    assert (mode, step) == ("resume", 3)


# --- the training CLI's scst stage -----------------------------------------

def _stage(cli, argv):
    args = cli.create_parser().parse_args(argv)
    extra = cli.resolve_stage(args)
    fn = extra.pop("stage_fn")
    return vars(args), extra, fn


@pytest.mark.parametrize("extra_argv", [
    [], ["--scst_beam_size", "5", "--scst_weight_bleu", "1,0,0,0.5",
         "--scst_weight_ciderD", "0.5", "--run", "2"]])
def test_cli_scst_stage_matches(tmp_path, extra_argv):
    """The scst stage needs the cnn_finetune directory, then sets
    comic_tpu's overrides, names the run as comic_tpu does and trains with
    train_fn_scst."""
    argv = ["--train_mode", "scst", "--log_root", str(tmp_path),
            "--dataset_dir", str(tmp_path / "data")] + extra_argv
    run = 2 if "--run" in extra_argv else 1
    name = "radix_b256_add_LN_softmax_h8_tie_lstm"
    cnnft = str(tmp_path / f"{name}_cnnFT_run_{run:02d}")
    for cli in (tcli, jcli):
        with pytest.raises(ValueError, match="CNN finetune log path"):
            cli.resolve_stage(cli.create_parser().parse_args(argv))
        with pytest.raises(NotImplementedError):
            cli.resolve_stage(cli.create_parser().parse_args(
                argv + ["--legacy"]))
    os.makedirs(cnnft)
    t_args, t_extra, t_fn = _stage(tcli, argv)
    j_args, j_extra, _ = _stage(jcli, argv)
    assert t_args == j_args and t_extra == j_extra
    assert t_fn is tscst.train_fn_scst
    assert (t_args["batch_size_train"], t_args["lr_start"],
            t_args["max_epoch"], t_args["freeze_scopes"],
            t_args["checkpoint_path"]) == (10, 1e-3, 10, "encoder/cnn", cnnft)
    want = ("beam_7_CrD_1.0_B1_0.0_B4_2.0" if not extra_argv
            else "beam_5_CrD_0.5_B1_1.0_B4_0.5")
    assert os.path.basename(t_extra["log_path"]) == \
        f"{name}_cnnFT_SCST_{want}_run_{run:02d}"
    fn, config = tcli.stage_config(argv)
    assert fn is tscst.train_fn_scst
    assert list(config.scst_weight_bleu) == t_args["scst_weight_bleu"]
    assert config.scst_beam_size == t_args["scst_beam_size"]


def test_cli_scst_needs_the_card(tmp_path):
    """``main --train_mode scst`` trains on the card: without one it
    raises (no CPU fallback) and records the error beside the run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    name = "radix_b256_add_LN_softmax_h8_tie_nocard"
    os.makedirs(tmp_path / f"{name}_cnnFT_run_01")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--train_mode", "scst", "--name", "nocard", "--log_root",
                   str(tmp_path), "--dataset_dir", str(tmp_path)])
    errs = [f for f in os.listdir(tmp_path) if f.startswith("error__")]
    assert len(errs) == 1 and re.search(r"_cnnFT_SCST_beam_7_", errs[0])
    with open(tmp_path / errs[0]) as f:
        assert "RuntimeError" in f.read()
