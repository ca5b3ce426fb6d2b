"""comic_tpu_torch's XE training path against comic_tpu's on the CPU: the
losses, the teacher-forced decode with and without dropout (comic_tpu's
own dropout draws, handed to the port as masks), the gradients of
xe_forward, and both train_fn drivers from one checkpoint (losses, eval
perplexity, final parameters, artifacts), with full checkpoints resumed
across the two packages."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from comic_tpu.configuration import Config as JConfig
from comic_tpu.configuration import load_config as jload_config
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.models import captioner as jcap
from comic_tpu.models import decoder as jdec
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.training import checkpoints as jckpt
from comic_tpu.training import xe as jxe
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.configuration import load_config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.models import decoder as tdec
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import xe as txe

torch.set_num_threads(1)

WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}
SMALL = dict(token_type="radix", radix_base=16, rnn_size=32,
             rnn_word_size=16, attn_num_heads=2, compute_dtype="float32",
             cnn_input_size=(64, 64))
# float32 forward: the same operations, summed in other orders
TOL_F32 = dict(rtol=1e-5, atol=1e-5)


def _specs(**kw):
    cfg = dict(SMALL, **kw)
    return (jcap.build_model_spec(JConfig(**cfg), JVocabulary(dict(WTOI))),
            tcap.build_model_spec(Config(**cfg), Vocabulary(dict(WTOI))))


def _captions(rng, batch, width, softmax):
    """Radix-plane captions: GO, digits, EOS, then -1 pads; rows of
    different lengths."""
    caps = np.full((batch, width), -1, np.int32)
    for i in range(batch):
        n = int(rng.integers(2, width - 1))
        caps[i, 0] = softmax - 2
        caps[i, 1:n] = rng.integers(0, softmax - 2, n - 1)
        caps[i, n] = softmax - 1
    return caps


def _jax_dropout(cfg, rng, batch, steps, positions):
    """The masks comic_tpu's teacher_forced draws from ``rng``
    (decoder.py:235-262, cells.apply_dropout, attention.attend), as the
    port's DropoutMasks."""
    noise_in = noise_out = None
    if cfg.recurrent_dropout:
        rng, k_in, k_out = jax.random.split(rng, 3)
        for name, k, p, n in (("in", k_in, 1 - cfg.dropout_in,
                               cfg.rnn_input_size),
                              ("out", k_out, 1 - cfg.dropout_out,
                               cfg.rnn_size)):
            if p < 1:
                m = jnp.where(jax.random.bernoulli(k, p, (batch, n)),
                              1.0 / p, 0.0)
                if name == "in":
                    noise_in = m
                else:
                    noise_out = m
    keep_in, keep_out, keep_align = [], [], []
    for key in jax.random.split(rng, steps):
        k1, k2, k3 = jax.random.split(key, 3)
        keep_in.append(jax.random.bernoulli(
            k1, 1 - cfg.dropout_in, (batch, cfg.rnn_input_size)))
        keep_out.append(jax.random.bernoulli(
            k2, 1 - cfg.dropout_out, (batch, cfg.rnn_size)))
        keep_align.append(jax.random.bernoulli(
            k3, cfg.attn_keep_prob,
            (batch, cfg.attention.num_heads, positions)))

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    recurrent = cfg.recurrent_dropout
    return tdec.DropoutMasks(
        keep_in=None if recurrent else t(np.stack(keep_in)),
        keep_out=None if recurrent else t(np.stack(keep_out)),
        keep_align=t(np.stack(keep_align)),
        noise_in=t(noise_in), noise_out=t(noise_out))


@pytest.mark.parametrize("mode", ["off", "step_dropout",
                                  "recurrent_dropout"])
def test_teacher_forced_matches(mode):
    """Logits and alignments in f32 at 1e-5; with dropout the port takes
    comic_tpu's own draws as masks."""
    jspec, tspec = _specs(rnn_recurr_dropout=mode == "recurrent_dropout")
    cfg_j, cfg_t = jspec.decoder, tspec.decoder
    rng = np.random.default_rng(0)
    b, t, l = 3, 7, 10
    inputs = _captions(rng, b, t + 1, cfg_t.softmax_size)[:, :-1]
    im_embed = rng.normal(size=(b, 1024)).astype(np.float32)
    fmap = rng.normal(size=(b, l, 832)).astype(np.float32)
    pj = jax.tree_util.tree_map(
        np.asarray, jdec.decoder_init(jax.random.PRNGKey(1), cfg_j))
    key = jax.random.PRNGKey(7)
    training = mode != "off"
    logits_j, align_j = jdec.teacher_forced(
        pj, cfg_j, jnp.asarray(inputs), jnp.asarray(im_embed),
        jnp.asarray(fmap), rng=key if training else None, training=training)
    masks = _jax_dropout(cfg_j, key, b, t, l) if training else None
    logits_t, align_t = tdec.teacher_forced(
        bridge.from_jax_tree(pj, "cpu"), cfg_t, torch.from_numpy(inputs),
        torch.from_numpy(im_embed), torch.from_numpy(fmap),
        training=training, dropout=masks)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               **TOL_F32)
    np.testing.assert_allclose(align_t.numpy(), np.asarray(align_j),
                               **TOL_F32)


def test_dropout_draws_have_comic_tpu_shapes_and_rates():
    _, tspec = _specs(attn_keep_prob=0.9)
    cfg = tspec.decoder
    g = torch.Generator().manual_seed(0)
    m = tdec.draw_dropout_masks(cfg, 64, 5, 10, g, torch.device("cpu"))
    assert m.keep_in.shape == (5, 64, cfg.rnn_input_size)
    assert m.keep_out.shape == (5, 64, cfg.rnn_size)
    assert m.keep_align.shape == (5, 64, 2, 10)
    assert m.noise_in is None and m.noise_out is None
    assert abs(m.keep_in.float().mean().item() - 0.65) < 0.02
    assert abs(m.keep_align.float().mean().item() - 0.9) < 0.02
    rec = tdec.draw_dropout_masks(cfg._replace(recurrent_dropout=True),
                                  64, 5, 10, g, torch.device("cpu"))
    assert rec.keep_in is None and rec.noise_in.shape == (64, 48)
    assert set(rec.noise_in.unique().tolist()) == {0.0, float(np.float32(
        1 / 0.65))}
    off = tdec.draw_dropout_masks(
        cfg._replace(dropout_in=0.0, dropout_out=0.0, attn_keep_prob=1.0),
        64, 5, 10, g, torch.device("cpu"))
    assert off == tdec.DropoutMasks()


def test_losses_match():
    rng = np.random.default_rng(3)
    caps = _captions(rng, 4, 9, 18)
    ji, jt, jm = jcap.process_captions(jnp.asarray(caps))
    ti, tt, tm = tcap.process_captions(torch.from_numpy(caps))
    for a, b in ((ti, ji), (tt, jt), (tm, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    logits = rng.normal(size=(4, 8, 18)).astype(np.float32) * 3
    for avg in (True, False):
        np.testing.assert_allclose(
            tcap.sequence_loss(torch.from_numpy(logits), tt, tm,
                               average_across_batch=avg).numpy(),
            np.asarray(jcap.sequence_loss(jnp.asarray(logits), jt, jm,
                                          average_across_batch=avg)),
            rtol=1e-6)
    align = rng.random((4, 8, 2, 5)).astype(np.float32)
    for scale, valid in ((1.0, None), (1.0, 5), (0.7, 8), (0.0, 3)):
        want = jcap.attention_map_loss(
            jnp.asarray(align), scale,
            valid_steps=None if valid is None else jnp.asarray(valid))
        got = tcap.attention_map_loss(torch.from_numpy(align), scale,
                                      valid_steps=valid)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# Gradients, each leaf against its own scale:
# - float32: max |port - jax| <= 1e-4 of the leaf's largest gradient (the
#   backward passes sum in other orders). The three stem convs before
#   MaxPool_3a get 1e-2 (measured 4.5e-3): at these images a window of
#   MaxPool_3a holds two Conv2d_2c values closer than float32 rounding, so
#   the rounding decides which one the pool takes, and the two packages'
#   convolutions round them in other orders; the cotangent routed to that
#   window differs, and the stem's kernels sum it back over the image.
# - bfloat16, loosely: the decoder's leaves within 5e-2 of the leaf's
#   largest gradient (both round the same matmul operands and cotangents
#   to bf16; the kernels round the rest in other orders), the loss within
#   1e-3; the CNN's convolutions run in bf16 end to end (57 layers of
#   bf16 activations and cotangents), so its leaves are held by direction:
#   cosine similarity >= 0.9 (measured >= 0.956).
STEM = ("Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3")


def _check_leaf(path, got, want, dtype):
    name = "/".join(path)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        tol = 1e-2 if path[2:3] and path[2] in STEM else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=name)
    elif path[0] == "decoder":
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale,
                                   err_msg=name)
    else:
        g, w = got.ravel(), want.ravel()
        cos = float(g @ w) / float(np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.9, (name, cos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xe_forward_gradients_match_jax_grad(dtype):
    """d log_ppl / d param for every trainable leaf (BN moving statistics
    are never trainable) of the whole model, CNN included."""
    _xe_gradients_match(dtype)


def _xe_gradients_match(dtype, freeze_scopes="", **kw):
    """The loss and every trainable leaf's gradient of xe_forward, the port
    against jax.grad of comic_tpu's, for SMALL with ``kw`` changed; frozen
    are the BN statistics and the leaves ``freeze_scopes`` matches."""
    jspec, tspec = _specs(compute_dtype=dtype, **kw)
    rng = np.random.default_rng(4)
    pj = jax.tree_util.tree_map(
        np.asarray, jcap.init_params(jax.random.PRNGKey(2), jspec))
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    # GO and EOS end the id plane, as _captions draws it (radix: base and
    # base + 1; word tokens: the vocabulary's <GO> and <EOS>)
    _, end_id = tcap.start_end_ids(Config(**dict(SMALL, **kw)),
                                   Vocabulary(dict(WTOI)))
    caps = _captions(rng, 2, 7, end_id + 1)

    def loss(p):
        return jcap.xe_forward(p, jspec, jnp.asarray(images),
                               jnp.asarray(caps))[0]

    lj, gj = jax.jit(jax.value_and_grad(loss))(pj)
    pt = bridge.from_jax_tree(pj, "cpu")
    mask = topt.trainable_mask(pt, freeze_scopes)
    topt.set_trainable(pt, mask)
    lt, _ = tcap.xe_forward(pt, tspec,
                            torch.from_numpy(images).permute(0, 3, 1, 2),
                            torch.from_numpy(caps))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj),
                               rtol=1e-6 if dtype == "float32" else 1e-3)
    grads = bridge.to_jax_tree(topt._map_paths(
        lambda path, v: v.grad if v.grad is not None
        else torch.zeros_like(v), pt))
    leaves = [(path, g) for path, g in topt.tree_items(grads)
              if topt.tree_get(mask, path)]
    # the CNN's kernels and betas and the decoder, or the decoder alone
    assert len(leaves) > (100 if not freeze_scopes else 5)
    for path, g in leaves:
        _check_leaf(path, g, np.asarray(topt.tree_get(gj, path)), dtype)


# --- the whole driver -------------------------------------------------------

DRIVER = dict(SMALL, dataset_file_pattern="synth_{}", batch_size_train=4,
              batch_size_eval=4, max_epoch=500, lr_start=3e-3, lr_end=1e-4,
              dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
              cnn_input_augment=False, num_logs_per_epoch=1,
              freeze_scopes="encoder/cnn", rand_seed=0, num_data_shards=1)
# 4 XE steps in f32 from one checkpoint: the two drivers' float32 sums
# run in other orders, and 4 Adam steps carry that forward
DRIVER_RTOL = 1e-4


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """comic_tpu's and the port's train_fn, 4 steps each from one compact
    checkpoint, on the synthetic fixture -> (root, jax dir, port dir)."""
    root = tmp_path_factory.mktemp("xe")
    data, vocab = make_synthetic_dataset(
        str(root / "data"), num_train=8, num_valid=4, num_test=4,
        captions_per_image=1)
    jspec = jcap.build_model_spec(JConfig(**DRIVER), vocab)
    init = jax.tree_util.tree_map(
        np.asarray, jcap.init_params(jax.random.PRNGKey(5), jspec))
    start = str(root / "start")
    jckpt.save_checkpoint(start, 1, init)
    out = {}
    for name in ("jax", "port"):
        kw = dict(DRIVER, dataset_dir=data, checkpoint_path=start,
                  log_path=str(root / name))
        if name == "jax":
            jxe.train_fn(JConfig(**kw), max_steps_override=4)
        else:
            txe.train_fn(Config(**kw), max_steps_override=4, device="cpu")
        out[name] = str(root / name)
    return root, out["jax"], out["port"]


def _events(d):
    import json

    with open(os.path.join(d, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_drivers_agree(drivers):
    _, jdir, tdir = drivers
    ej, et = _events(jdir), _events(tdir)
    assert [sorted(e) for e in et] == [sorted(e) for e in ej]
    assert [e["step"] for e in et] == [2, 2, 4, 4]
    for a, b in zip(et, ej):
        for k in a:
            if k in ("time", "examples_per_sec"):
                continue
            np.testing.assert_allclose(a[k], b[k], rtol=DRIVER_RTOL,
                                       atol=1e-7, err_msg=k)
    with open(os.path.join(jdir, "model_size.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(tdir, "model_size.txt"), "rb") as f:
        assert f.read() == want
    final_j = jckpt.load_compact(jdir, serialization.msgpack_restore(
        open(os.path.join(jdir, "model_compact-4.msgpack"), "rb").read()))
    final_t = bridge.to_jax_tree(tckpt.load_compact(
        tdir, bridge.from_jax_tree(final_j, "cpu")))
    for path, a in topt.tree_items(final_t):
        b = np.asarray(topt.tree_get(final_j, path))
        np.testing.assert_allclose(
            a, b, rtol=DRIVER_RTOL,
            atol=DRIVER_RTOL * float(np.abs(b).max()),
            err_msg=topt.path_string(path))
    # both artifact sets, and each config.pkl loads in both packages
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".msgpack")) \
        == sorted(f for f in os.listdir(jdir) if f.endswith(".msgpack"))
    for d in (jdir, tdir):
        assert load_config(d).wtoi == jload_config(d).wtoi
        assert load_config(d).max_step == jload_config(d).max_step == 4
        with open(os.path.join(d, "config.pkl"), "rb") as f:
            assert pickle.load(f)["_comic_tpu_config_version"] == 2


def _full(d):
    with open(os.path.join(d, "model-4.msgpack"), "rb") as f:
        return serialization.msgpack_restore(f.read())


def _equal_tree(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal_tree(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _port_resume(d, vocab_cfg):
    spec = tcap.build_model_spec(vocab_cfg, Vocabulary.from_str_itow(
        vocab_cfg.wtoi, vocab_cfg.itow))
    params = tcap.init_params(spec, device="cpu")
    opt = topt.Optimizer(params, lambda s: 1e-3, freeze_scopes="encoder/cnn")
    params, step, mode = tckpt.restore_model(params, d, resume=True,
                                             optimizer=opt)
    return params, opt, step, mode


def test_comic_tpu_full_checkpoint_resumes_in_port(drivers):
    _, jdir, _ = drivers
    want = _full(jdir)
    params, opt, step, mode = _port_resume(jdir, load_config(jdir))
    assert (mode, step) == ("resume", 4)
    _equal_tree(bridge.to_jax_tree(params), want["params"])
    _equal_tree(opt.state_dict(params), want["opt_state"])
    assert opt.count == 4


def test_port_full_checkpoint_resumes_in_comic_tpu(drivers):
    _, _, tdir = drivers
    want = _full(tdir)
    assert want["step"] == 4 and want["step"].dtype == np.int64
    cfg = jload_config(tdir)
    vocab = JVocabulary.from_str_itow(cfg.wtoi, cfg.itow)
    spec = jcap.build_model_spec(cfg, vocab)
    params = jcap.init_params(jax.random.PRNGKey(0), spec)
    opt, _ = jopt_build(params, cfg)
    restored, opt_state, step, mode = jckpt.restore_model(
        params, tdir, resume=True, opt_state=opt.init(params))
    assert (mode, step) == ("resume", 4)
    _equal_tree(jax.tree_util.tree_map(np.asarray, restored),
                want["params"])
    _equal_tree(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, opt_state)), want["opt_state"])


def jopt_build(params, cfg):
    from comic_tpu.training.optimizer import build_optimizer
    from comic_tpu.training.schedule import cosine_schedule

    return build_optimizer(params, cosine_schedule(1e-3, 1e-4, 4),
                           freeze_scopes=cfg.freeze_scopes,
                           adam_epsilon=cfg.adam_epsilon)


def test_resumed_port_run_continues(drivers):
    """A port run resumed from comic_tpu's full checkpoint takes its next
    steps from the restored step and optimizer count."""
    root, jdir, _ = drivers
    cfg = load_config(jdir)
    cfg.update(resume_training=True, checkpoint_path=jdir,
               log_path=str(root / "resumed"))
    metrics = txe.train_fn(cfg, max_steps_override=6, device="cpu")
    assert np.isfinite(metrics["total_loss"])
    state = _full_at(str(root / "resumed"), 6)
    assert state["step"] == 6
    assert int(state["opt_state"]["1"]["inner_state"]["1"]["count"]) == 6


def _full_at(d, step):
    with open(os.path.join(d, f"model-{step}.msgpack"), "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_steps_per_call_runs_single_steps(drivers):
    """train_steps_per_call=2 runs the steps one by one: the same logged
    losses and bit-equal final parameters as the 4 single-step run (as
    comic_tpu's scan of K is bit-equal to its single steps)."""
    root, _, tdir = drivers
    data = os.path.join(str(root), "data")
    kw = dict(DRIVER, dataset_dir=data,
              checkpoint_path=os.path.join(str(root), "start"),
              log_path=str(root / "port_k2"), train_steps_per_call=2)
    txe.train_fn(Config(**kw), max_steps_override=4, device="cpu")
    got, want = _events(str(root / "port_k2")), _events(tdir)
    assert [e["step"] for e in got] == [e["step"] for e in want]
    for a, b in zip(got, want):
        for k in ("log_ppl", "total_loss", "eval_perplexity"):
            assert a.get(k) == b.get(k)
    with open(os.path.join(str(root / "port_k2"),
                           "model_compact-4.msgpack"), "rb") as f:
        k2 = f.read()
    with open(os.path.join(tdir, "model_compact-4.msgpack"), "rb") as f:
        assert f.read() == k2
    # profile_dir is taken (the step tracer): its window, the loop's calls
    # [10, 13), lies past these 2 calls, so no trace and the same weights
    kw.update(log_path=str(root / "port_k2_traced"),
              profile_dir=str(root / "p"))
    txe.train_fn(Config(**kw), max_steps_override=4, device="cpu")
    assert not os.path.exists(str(root / "p"))
    with open(os.path.join(kw["log_path"], "model_compact-4.msgpack"),
              "rb") as f:
        assert f.read() == k2
