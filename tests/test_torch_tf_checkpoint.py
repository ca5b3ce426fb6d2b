"""comic_tpu_torch's TF-checkpoint restores against comic_tpu's on the CPU,
on TF1-format checkpoints written here with tf.compat.v1: a slim
Inception-V1 ImageNet checkpoint (mode 'cnn', by file, by directory and
through convert_slim_checkpoint and net_params; and of two zoo encoders,
one with depthwise kernels), reference COMIC TF1
models (default radix and legacy word tokens; load_compact, restore_model
mode 'model', convert_reference_checkpoint), the failures and skips of
both converters, and retention beside TF checkpoints.

Every test that imports TensorFlow lives in this file, so one worker pays
for it. Trees are compared with np.array_equal in comic_tpu's layout
(before the weight bridge) and exactly after it."""

import os

import jax
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.models import captioner as jcap
from comic_tpu.models.encoders import get_encoder as jget_encoder
from comic_tpu.training import checkpoints as jckpt
from comic_tpu.utils import net_params as jnet
from comic_tpu.utils import tf_checkpoint as jtfc
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.utils import net_params as tnet
from comic_tpu_torch.utils import tf_checkpoint as ttfc
from test_reference_ckpt import (RNN_DEC, _flat_paths, _flatten,
                                 _manufacture, _rand_like,
                                 _reference_var_names, _vocab,
                                 _write_tf1_checkpoint)

tf = pytest.importorskip("tensorflow")
torch.set_num_threads(1)

RADIX = dict(token_type="radix", radix_base=32, rnn_size=64,
             rnn_word_size=16, attn_num_heads=4)
LEGACY_WORD = dict(token_type="word", legacy=True, rnn_size=64,
                   rnn_word_size=16, attn_num_heads=4)


def _equal(got, want, path=""):
    """Same keys at every level, every leaf np.array_equal with one dtype."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_init(kw, vocab):
    spec = tcap.build_model_spec(Config(**kw), Vocabulary(dict(vocab.wtoi)))
    return tcap.init_params(spec, device="cpu")


def _port_encoder_init():
    from comic_tpu_torch.models.encoders import get_encoder

    return get_encoder("inception_v1").init(torch.Generator().manual_seed(0))


def _save_slim(directory, name_to_array, name="inception_v1.ckpt"):
    v1 = tf.compat.v1
    g = v1.Graph()
    with g.as_default():
        for var, arr in name_to_array.items():
            v1.get_variable(var, initializer=tf.constant(np.asarray(arr)))
        saver = v1.train.Saver()
        with v1.Session(graph=g) as sess:
            sess.run(v1.global_variables_initializer())
            return saver.save(sess, os.path.join(directory, name),
                              write_meta_graph=False)


@pytest.fixture(scope="module")
def slim(tmp_path_factory):
    """A slim Inception-V1 ImageNet checkpoint of seeded values, with a
    classifier head, optimizer slots and global_step that conversion must
    drop -> (ckpt path, the CNN tree)."""
    d = tmp_path_factory.mktemp("slim")
    rng = np.random.default_rng(1)
    cnn = _rand_like(rng, jget_encoder("inception_v1").init(
        jax.random.PRNGKey(0)))
    names = _flatten(cnn, "InceptionV1")
    first = next(iter(names))
    names.update({
        "InceptionV1/Logits/Conv2d_0c_1x1/weights":
            np.zeros((1, 1, 1024, 1001), np.float32),
        first + "/Momentum": np.full_like(names[first], 3.0),
        first + "/Adam_1": np.full_like(names[first], 4.0),
        "global_step": np.int64(17)})
    return _save_slim(str(d), names), cnn


@pytest.mark.parametrize("by", ["file", "file.index", "directory"])
def test_slim_cnn_restore_matches_comic_tpu(slim, by):
    path, cnn = slim
    query = {"file": path, "file.index": path + ".index",
             "directory": os.path.dirname(path)}[by]
    vocab = _vocab()
    init_t = _port_init(RADIX, vocab)
    init_j = bridge.to_jax_tree(init_t)
    got, step, mode = tckpt.restore_model(init_t, query)
    want, _, jstep, jmode = jckpt.restore_model(init_j, query)
    assert (mode, step) == (jmode, jstep) == ("cnn", 0)
    _equal(bridge.to_jax_tree(got), _np(want))
    _equal(bridge.to_jax_tree(got)["encoder"]["cnn"], cnn)
    # the decoder keeps its initial values
    assert torch.equal(got["decoder"]["embedding"],
                       init_t["decoder"]["embedding"])
    # an excluded scope keeps its initializer in the CNN branch too
    got, _, _ = tckpt.restore_model(init_t, query,
                                    exclude_scopes="Conv2d_1a_7x7")
    want, _, _, _ = jckpt.restore_model(init_j, query,
                                        exclude_scopes="Conv2d_1a_7x7")
    _equal(bridge.to_jax_tree(got), _np(want))


def test_slim_conversion_before_the_bridge(slim):
    """The converter's numpy trees equal comic_tpu's key for key."""
    path, cnn = slim
    tpl_t = bridge.to_jax_tree(_port_encoder_init())
    tpl_j = _np(jget_encoder("inception_v1").init(jax.random.PRNGKey(0)))
    got = ttfc.convert_slim_tree(ttfc.load_slim_checkpoint(path), tpl_t)
    want = jtfc.convert_slim_tree(jtfc.load_slim_checkpoint(path), tpl_j)
    _equal(got, want)
    _equal(got, cnn)
    names = ttfc.load_reference_checkpoint_vars(path)
    assert set(names) == set(jtfc.load_reference_checkpoint_vars(path))
    _equal(ttfc._detect_cnn_tree(names, "", tpl_t),
           jtfc._detect_cnn_tree(names, "", tpl_j))
    assert sorted(ttfc.reference_checkpoint_names(path)) == \
        sorted(jtfc.reference_checkpoint_names(path))


def test_convert_slim_checkpoint_matches_comic_tpu(slim, tmp_path):
    path, cnn = slim
    out_t = ttfc.convert_slim_checkpoint(path, str(tmp_path / "t.msgpack"))
    out_j = jtfc.convert_slim_checkpoint(path, str(tmp_path / "j.msgpack"))
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    init_t = _port_init(RADIX, _vocab())
    got, _, mode = tckpt.restore_model(init_t, out_t)
    assert mode == "cnn"
    _equal(bridge.to_jax_tree(got)["encoder"]["cnn"], cnn)
    # a checkpoint of another encoder: both find none of its variables
    for tfc in (ttfc, jtfc):
        with pytest.raises(KeyError, match="Missing converted variable"):
            tfc.convert_slim_checkpoint(path, str(tmp_path / "r.msgpack"),
                                        "resnet_v1_50")
    with pytest.raises(ValueError, match="No converter wiring"):
        ttfc.convert_slim_checkpoint(path, str(tmp_path / "r.msgpack"),
                                     "alexnet")


@pytest.mark.parametrize("cnn_name", ["mobilenet_v1", "resnet_v2_50"])
def test_convert_zoo_slim_checkpoints_match_comic_tpu(tmp_path, cnn_name):
    """Slim checkpoints of zoo encoders (depthwise kernels under
    MobilenetV1/, a pre-activation ResNet): both converters write the same
    bytes, and the port's restore through the bridge gives comic_tpu's
    tree."""
    rng = np.random.default_rng(2)
    cnn = _rand_like(rng, jax.eval_shape(jget_encoder(cnn_name).init,
                                         jax.random.PRNGKey(0)))
    ckpt = _save_slim(str(tmp_path), _flatten(cnn, jtfc.ROOT_SCOPES[cnn_name]),
                      f"{cnn_name}.ckpt")
    out_t = ttfc.convert_slim_checkpoint(ckpt, str(tmp_path / "t.msgpack"),
                                         cnn_name)
    out_j = jtfc.convert_slim_checkpoint(ckpt, str(tmp_path / "j.msgpack"),
                                         cnn_name)
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    spec = tcap.build_model_spec(Config(cnn_name=cnn_name, **RADIX),
                                 Vocabulary(dict(_vocab().wtoi)))
    got, _, mode = tckpt.restore_model(tcap.init_params(spec, device="cpu"),
                                       out_t)
    assert mode == "cnn"
    _equal(bridge.to_jax_tree(got)["encoder"]["cnn"], _np(cnn))


def test_net_params_match_comic_tpu(slim, tmp_path):
    path, _ = slim
    assert tnet.NET_PARAMS == jnet.NET_PARAMS
    assert tnet.DEFAULT_CKPT_DIR == jnet.DEFAULT_CKPT_DIR
    assert ttfc.ROOT_SCOPES == jtfc.ROOT_SCOPES
    assert ttfc._DROP_SCOPES == jtfc._DROP_SCOPES
    for name in ("inception_v1", "mobilenet_v2_140", "vgg_16"):
        for where in (None, str(tmp_path), path + ".index"):
            assert tnet.get_net_params(name, where) == \
                jnet.get_net_params(name, where)
    with pytest.raises(ValueError, match="Unknown network"):
        tnet.get_net_params("alexnet")
    # absent and no download: None, nothing fetched
    assert tnet.maybe_get_ckpt_file(
        tnet.get_net_params("inception_v1", str(tmp_path / "none"))) is None
    # a slim checkpoint on disk converts at first use, as comic_tpu's does
    outs = []
    for mod, sub in ((tnet, "port"), (jnet, "jax")):
        d = tmp_path / sub
        d.mkdir()
        for f in os.listdir(os.path.dirname(path)):
            if f.startswith("inception_v1.ckpt"):
                os.link(os.path.join(os.path.dirname(path), f), d / f)
        net = mod.get_net_params("inception_v1", str(d))
        outs.append(mod.maybe_get_ckpt_file(net))
        assert outs[-1] == net["converted_path"]
        assert mod.maybe_get_ckpt_file(net) == outs[-1]  # now cached
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kw", [RADIX, LEGACY_WORD],
                         ids=["radix", "legacy_word"])
def test_reference_model_restores_match_comic_tpu(rng, tmp_path, kw):
    """A reference model_compact-N (with planted slots and eval-graph
    duplicates) through load_compact, restore_model (file, directory,
    excluded scopes) and convert_reference_checkpoint."""
    source, path, template_j, _, vocab = _manufacture(JConfig(**kw), rng,
                                                      tmp_path)
    init_t = _port_init(kw, vocab)
    init_j = bridge.to_jax_tree(init_t)
    names = jtfc.load_reference_checkpoint_vars(path)
    # before the bridge: the converter's tree equals comic_tpu's
    got = ttfc.convert_reference_tree(names, init_j)
    _equal(got, jtfc.convert_reference_tree(names, _np(template_j)))
    _equal(got, _np(source))
    # after it: exact
    _equal(bridge.to_jax_tree(tckpt.load_compact(path, init_t)),
           _np(source))
    _equal(bridge.to_jax_tree(tckpt.load_compact(str(tmp_path), init_t)),
           _np(source))
    for query, excl in ((path, None), (str(tmp_path), None),
                        (path, "decoder/attention")):
        restored, step, mode = tckpt.restore_model(init_t, query,
                                                   exclude_scopes=excl)
        want, _, jstep, jmode = jckpt.restore_model(init_j, query,
                                                    exclude_scopes=excl)
        assert (mode, step) == (jmode, jstep) == ("model", 0)
        _equal(bridge.to_jax_tree(restored), _np(want))
    out_t = ttfc.convert_reference_checkpoint(
        path, Config(**kw), Vocabulary(dict(vocab.wtoi)),
        str(tmp_path / "port.msgpack"))
    out_j = jtfc.convert_reference_checkpoint(
        path, JConfig(**kw), vocab, str(tmp_path / "jax.msgpack"))
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()
    # the default output name sits beside the TF checkpoint
    default = ttfc.convert_reference_checkpoint(
        path, Config(**kw), Vocabulary(dict(vocab.wtoi)))
    assert os.path.basename(default) == "model_compact-777.msgpack"
    with open(default, "rb") as a:
        assert a.read() == open(out_j, "rb").read()


def test_reference_failures_match_comic_tpu(rng, tmp_path):
    """A missing decoder variable, a shape mismatch, a restore target that
    is not a full model, a slim checkpoint through load_compact, and a
    reference FULL checkpoint through load_full fail as in comic_tpu."""
    vocab = _vocab()
    config = JConfig(**RADIX)
    spec = jcap.build_model_spec(config, vocab)
    template = jcap.init_params(jax.random.PRNGKey(0), spec)
    source = _rand_like(rng, template)
    tf_vars = _flatten(source["encoder"]["cnn"],
                       "Model/encoder/cnn/InceptionV1")
    names = _reference_var_names(config, template["decoder"])
    for p, leaf in _flat_paths(source["decoder"]):
        tf_vars[names[p]] = np.asarray(leaf)
    del tf_vars[f"{RNN_DEC}/embedding_map"]
    (tmp_path / "missing").mkdir()
    path = _write_tf1_checkpoint(str(tmp_path / "missing"), tf_vars)
    init_t = _port_init(RADIX, vocab)
    for call in (
            lambda: tckpt.restore_model(init_t, path),
            lambda: tckpt.load_compact(path, init_t),
            lambda: ttfc.convert_reference_checkpoint(
                path, Config(**RADIX), Vocabulary(dict(vocab.wtoi)))):
        with pytest.raises(KeyError, match="embedding_map"):
            call()
    with pytest.raises(KeyError, match="embedding_map"):
        jckpt.restore_model(bridge.to_jax_tree(init_t), path)

    (tmp_path / "shape").mkdir()
    _, path, _, _, _ = _manufacture(config, rng, tmp_path / "shape",
                                    plant_junk=False)
    other = dict(RADIX, rnn_size=32)
    small_t = _port_init(other, vocab)
    for call in (lambda: tckpt.restore_model(small_t, path),
                 lambda: jckpt.restore_model(
                     bridge.to_jax_tree(small_t), path)):
        with pytest.raises(ValueError, match="[Ss]hape"):
            call()
    for load in (tckpt.load_compact, jckpt.load_compact):
        with pytest.raises(ValueError, match="not a full model"):
            load(path, {"cnn": {}})


def test_slim_failures_match_comic_tpu(slim, tmp_path):
    path, cnn = slim
    init_t = _port_init(RADIX, _vocab())
    # a slim checkpoint is no model: load_compact refuses it by name
    for load, tpl in ((tckpt.load_compact, init_t),
                      (jckpt.load_compact, bridge.to_jax_tree(init_t))):
        with pytest.raises(ValueError, match="No `Model/` variables"):
            load(path, tpl)
    # a slim checkpoint missing a variable fails the CNN branch
    names = _flatten(cnn, "InceptionV1")
    del names["InceptionV1/Mixed_5c/Branch_3/Conv2d_0b_1x1/weights"]
    short = _save_slim(str(tmp_path), names)
    with pytest.raises(KeyError, match="Missing converted"):
        tckpt.restore_model(init_t, short)
    with pytest.raises(KeyError, match="Missing converted"):
        jckpt.restore_model(bridge.to_jax_tree(init_t), short)
    # load_slim_checkpoint drops slots, heads and off-scope variables; the
    # CNN branch's root-scope detection refuses a second top scope
    (tmp_path / "off").mkdir()
    names["OtherScope/weights"] = np.zeros((3,), np.float32)
    off = _save_slim(str(tmp_path / "off"), names)
    tree = ttfc.load_slim_checkpoint(off)
    assert "Logits" not in tree and "OtherScope" not in tree
    _equal(tree, jtfc.load_slim_checkpoint(off))
    for restore, tpl in ((tckpt.restore_model, init_t),
                         (jckpt.restore_model, bridge.to_jax_tree(init_t))):
        with pytest.raises(ValueError, match="do not match"):
            restore(tpl, off)


def test_resume_from_reference_full_checkpoint_fails_clearly(tmp_path):
    _save_slim(str(tmp_path), {"Model/x": np.zeros((2,), np.float32)},
               name="model-7")
    with pytest.raises(ValueError, match="model_compact"):
        tckpt.load_full(str(tmp_path))
    with pytest.raises(ValueError, match="model_compact"):
        jckpt.load_full(str(tmp_path), {"params": {}})
    with pytest.raises(ValueError, match="model_compact"):
        tckpt.restore_model(_port_init(RADIX, _vocab()), str(tmp_path),
                            resume=True)


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_prune_never_touches_or_counts_tf_checkpoints(tmp_path, backend):
    """Twelve reference TF checkpoints at high steps stay, and take no
    slot of a fresh run's retention."""
    v1 = tf.compat.v1
    g = v1.Graph()
    with g.as_default():
        v1.get_variable(f"{RNN_DEC}/embedding_map",
                        initializer=tf.constant(np.zeros((4, 2), np.float32)))
        saver = v1.train.Saver(max_to_keep=None)
        with v1.Session(graph=g) as sess:
            sess.run(v1.global_variables_initializer())
            for step in range(100000, 100012):
                saver.save(sess, str(tmp_path / f"model_compact-{step}"),
                           write_meta_graph=False)
    saver = tckpt.make_saver(backend)
    for step in (1, 2, 3, 4):
        saver.save(str(tmp_path), step, {"w": torch.tensor(float(step))},
                   max_saves=3)
    saver.close()
    names = os.listdir(tmp_path)
    assert sum(1 for n in names if n.endswith(".index")) == 12
    suffix = "." + backend
    assert sorted(n for n in names if n.endswith(suffix)) == \
        [f"model-{s}{suffix}" for s in (3, 4)] + \
        [f"model_compact-{s}{suffix}" for s in (2, 3, 4)]
    assert tckpt.list_checkpoints(str(tmp_path)) == \
        jckpt.list_checkpoints(str(tmp_path))
    tpl = {"w": torch.tensor(0.0)}
    assert tckpt.load_compact(
        str(tmp_path / "model_compact-4"), tpl)["w"].item() == 4.0


def test_converter_helpers_match_comic_tpu(rng, tmp_path):
    names = ["Model/decoder/rnn_decoder/decoder_1/w/query_layer/kernel",
             "Model/decoder/rnn_decoder/decoder/w/query_layer/kernel",
             "x/kernel/Adam", "x/kernel/Adam_1", "global_step",
             "x/kernel/Momentum", "Model/adamant/embedding_map",
             "beta1_power", "a/ExponentialMovingAverage"]
    for n in names:
        assert ttfc._is_slot_var(n) == jtfc._is_slot_var(n)
        assert ttfc._dup_scope_rank(n) == jtfc._dup_scope_rank(n)
    assert ttfc._pick_by_suffix(names, "query_layer/kernel") == \
        jtfc._pick_by_suffix(names, "query_layer/kernel") == names[1]
    for mod in (ttfc, jtfc):
        with pytest.raises(ValueError, match="Ambiguous"):
            mod._pick_by_suffix(["Model/decoder/a/query_layer/kernel",
                                 "Model/decoder/b/query_layer/kernel"],
                                "query_layer/kernel")
    for kw in (RADIX, LEGACY_WORD,
               dict(RADIX, rnn_name="GRU", rnn_init_method="project_hidden",
                    cnn_fm_projection="independent",
                    attn_context_layer=True)):
        dec = bridge.to_jax_tree(_port_init(kw, _vocab()))["decoder"]
        assert ttfc.decoder_suffix_map(dec) == jtfc.decoder_suffix_map(dec)
