"""comic_tpu_torch's Orbax checkpoints against comic_tpu's OrbaxCheckpointer
on the CPU: the port reads comic_tpu's compact and full directories
(tensorstore alone, no orbax), resumes from them with the optimizer state,
comic_tpu reads the port's back equal, a port training run writes them
through checkpoint_backend="orbax", and retention matches."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.models import captioner as jcap
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.training import checkpoints as jckpt
from comic_tpu.training.optimizer import build_optimizer
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.training import optimizer as topt
from comic_tpu_torch.training import orbax_store
from comic_tpu_torch.training import xe as txe

pytest.importorskip("tensorstore")
pytest.importorskip("orbax.checkpoint")
torch.set_num_threads(1)

WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}
SMALL = dict(token_type="radix", radix_base=16, rnn_size=32,
             rnn_word_size=16, attn_num_heads=2, compute_dtype="float32")
FREEZE = "encoder/cnn"


def _equal(got, want, path=""):
    """Same nested keys; leaves equal in dtype, shape and value."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_spec():
    return jcap.build_model_spec(JConfig(**SMALL), JVocabulary(dict(WTOI)))


def _port_init():
    spec = tcap.build_model_spec(Config(**SMALL), Vocabulary(dict(WTOI)))
    return tcap.init_params(spec, device="cpu")


def _jax_opt(params):
    opt, _ = build_optimizer(params, lambda s: 1e-3, freeze_scopes=FREEZE,
                             adam_epsilon=1e-6)
    return opt


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """comic_tpu's OrbaxCheckpointer after two Adam updates of seeded
    gradients -> (dir, params, flax state dict of the optimizer)."""
    d = str(tmp_path_factory.mktemp("jax_orbax"))
    params = _np(jcap.init_params(jax.random.PRNGKey(1), _jax_spec()))
    opt = _jax_opt(params)
    state = opt.init(params)
    rng = np.random.default_rng(0)

    @jax.jit
    def update(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params,
                                      updates), state

    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(x.dtype), params)
        params, state = update(grads, state, params)
        params = _np(params)
    state = _np(state)
    saver = jckpt.OrbaxCheckpointer()
    saver.save(d, 5, params, state)
    saver.close()
    return d, params, serialization.to_state_dict(state)


def test_layout_is_comic_tpus(jax_run):
    d, _, _ = jax_run
    assert sorted(os.listdir(d)) == ["model-5.orbax", "model_compact-5.orbax"]
    names = set(os.listdir(os.path.join(d, "model-5.orbax")))
    assert {"_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
            "d"} <= names


def test_port_reads_comic_tpu_compact(jax_run):
    d, params, _ = jax_run
    init = _port_init()
    for query in (d, os.path.join(d, "model_compact-5"),
                  os.path.join(d, "model_compact-5.orbax")):
        _equal(bridge.to_jax_tree(tckpt.load_compact(query, init)), params)
    restored, step, mode = tckpt.restore_model(init, d)
    assert (mode, step) == ("model", 0)
    _equal(bridge.to_jax_tree(restored), params)
    # before the bridge: the tree tensorstore reads is flax's state dict
    _equal(orbax_store.read_tree(os.path.join(d, "model_compact-5.orbax")),
           params)


def test_port_resumes_from_comic_tpu_full(jax_run):
    d, params, opt_state = jax_run
    full = tckpt.load_full(d)
    assert full["step"] == 5 and full["step"].dtype == np.int64
    _equal(full["opt_state"], opt_state)
    init = _port_init()
    opt = topt.Optimizer(init, lambda s: 1e-3, freeze_scopes=FREEZE,
                         adam_epsilon=1e-6)
    restored, step, mode = tckpt.restore_model(init, d, resume=True,
                                               optimizer=opt)
    assert (mode, step) == ("resume", 5)
    _equal(bridge.to_jax_tree(restored), params)
    _equal(opt.state_dict(restored), opt_state)
    assert opt.count == 2


def test_comic_tpu_reads_port_checkpoints(tmp_path):
    """A port optimizer after two steps, saved by make_saver("orbax"),
    restores in comic_tpu (compact, and full with the optax state)."""
    params = _port_init()
    opt = topt.Optimizer(params, lambda s: 1e-3, freeze_scopes=FREEZE,
                         adam_epsilon=1e-6)
    topt.set_trainable(params, opt.mask)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        for path in opt.paths:
            leaf = topt.tree_get(params, path)
            leaf.grad = torch.randn(leaf.shape, generator=gen)
        opt.step(params)
    saver = tckpt.make_saver("orbax")
    saver.save(str(tmp_path), 7, params, opt.state_dict(params))
    saver.close()
    want_params = bridge.to_jax_tree(params)
    want_opt = opt.state_dict(params)
    init_j = _np(jcap.init_params(jax.random.PRNGKey(0), _jax_spec()))
    _equal(_np(jckpt.load_compact(str(tmp_path), init_j)), want_params)
    restored, opt_state, step, mode = jckpt.restore_model(
        init_j, str(tmp_path), resume=True,
        opt_state=_jax_opt(init_j).init(init_j))
    assert (mode, step) == ("resume", 7)
    _equal(_np(restored), want_params)
    _equal(serialization.to_state_dict(_np(opt_state)), want_opt)
    # and the port reads its own back
    _equal(tckpt.load_full(str(tmp_path))["opt_state"], want_opt)


@pytest.mark.parametrize("max_saves", [1, 3])
def test_retention_matches_comic_tpu(tmp_path, max_saves):
    """Steps 1..5 through the port's Orbax saver and comic_tpu's leave the
    same directories; a reference TF checkpoint takes no slot and stays."""
    params = _port_init()
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        d.mkdir()
        (d / "model_compact-100.index").write_bytes(b"")
    saver = tckpt.make_saver("orbax")
    jsaver = jckpt.OrbaxCheckpointer()
    for step in range(1, 6):
        saver.save(str(port), step, params, max_saves=max_saves)
        jsaver.save(str(ref), step, bridge.to_jax_tree(params),
                    max_saves=max_saves)
    saver.close()
    jsaver.close()
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert "model_compact-100.index" in os.listdir(port)
    assert tckpt.list_checkpoints(str(port)) == \
        jckpt.list_checkpoints(str(ref))
    with pytest.raises(RuntimeError, match="after close"):
        saver.save(str(port), 6, params)


def test_train_fn_writes_orbax_that_comic_tpu_resumes(tmp_path):
    """checkpoint_backend="orbax": the port's train_fn writes Orbax
    directories; comic_tpu resumes from them with its optimizer."""
    data, vocab = make_synthetic_dataset(
        str(tmp_path / "data"), num_train=4, num_valid=2, num_test=2,
        captions_per_image=1, image_size=64)
    kw = dict(SMALL, dataset_file_pattern="synth_{}", batch_size_train=2,
              batch_size_eval=2, max_epoch=50, cnn_input_size=(64, 64),
              num_logs_per_epoch=1, freeze_scopes=FREEZE, rand_seed=0,
              num_data_shards=1, dataset_dir=data,
              log_path=str(tmp_path / "run"), checkpoint_backend="orbax")
    txe.train_fn(Config(**kw), max_steps_override=2, device="cpu")
    saved = sorted(f for f in os.listdir(tmp_path / "run")
                   if f.endswith(".orbax"))
    assert saved == ["model-2.orbax", "model_compact-2.orbax"]
    cfg = JConfig(**{k: v for k, v in kw.items()})
    jspec = jcap.build_model_spec(cfg, vocab)
    init_j = _np(jcap.init_params(jax.random.PRNGKey(0), jspec))
    opt, _ = build_optimizer(init_j, lambda s: 1e-3, freeze_scopes=FREEZE,
                             adam_epsilon=cfg.adam_epsilon)
    restored, opt_state, step, mode = jckpt.restore_model(
        init_j, str(tmp_path / "run"), resume=True,
        opt_state=opt.init(init_j))
    assert (mode, step) == ("resume", 2)
    full = tckpt.load_full(str(tmp_path / "run"))
    _equal(_np(restored), full["params"])
    _equal(serialization.to_state_dict(_np(opt_state)), full["opt_state"])
    assert int(full["opt_state"]["1"]["inner_state"]["1"]["count"]) == 2
