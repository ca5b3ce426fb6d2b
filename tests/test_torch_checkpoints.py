"""comic_tpu_torch's msgpack codec, compact checkpoints and weight bridge,
in both directions against comic_tpu / flax."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from comic_tpu.configuration import Config as JConfig
from comic_tpu.models import captioner as jcap
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.training import checkpoints as jckpt
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.training.msgpack_codec import packb, unpackb

torch.set_num_threads(1)

WTOI = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
        "<EOS>": 5}
SMALL = dict(token_type="radix", radix_base=16, rnn_size=32,
             rnn_word_size=16, attn_num_heads=2, compute_dtype="float32")


def _assert_tree_equal(got, want):
    """Same nested dicts/lists, same leaves (arrays by dtype, shape and
    value; other leaves by value)."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.fixture(scope="module")
def jax_tree():
    """comic_tpu's init tree of a small COMIC model, as numpy."""
    spec = jcap.build_model_spec(JConfig(**SMALL), JVocabulary(dict(WTOI)))
    return jax.tree_util.tree_map(
        np.asarray, jcap.init_params(jax.random.PRNGKey(0), spec))


def _spec():
    return tcap.build_model_spec(Config(**SMALL), Vocabulary(dict(WTOI)))


@pytest.mark.parametrize("obj", [
    {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
     "b": {"c": np.zeros((0, 4), np.int32), "d": np.float32(5.0)}},
    {"s": "x" * 40, "t": "y" * 300, "n": None, "f": True, "g": False},
    {"ints": [0, 1, 127, 128, -1, -32, -33, 2 ** 40, -(2 ** 40)],
     "floats": [0.5, -1.25e-30], "bin": b"\x00\x01" * 200},
    {"arr": np.arange(70000, dtype=np.int64), "u8": np.ones((3, 5), np.uint8),
     "scalar": np.int64(7), "zero_d": np.array(2.5, np.float32)},
    {f"k{i}": i for i in range(40)},
])
def test_codec_matches_flax(obj):
    """Bytes from the port decode with flax and vice versa, to the same
    tree."""
    ours = packb(obj)
    theirs = serialization.msgpack_serialize(obj)
    for data in (ours, theirs):
        for restored in (unpackb(data), serialization.msgpack_restore(data)):
            _assert_tree_equal(restored, obj)


def test_codec_rejects_garbage():
    with pytest.raises(ValueError):
        unpackb(packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError):
        unpackb(packb({"a": "long string"})[:-3])


def test_port_reads_comic_tpu_checkpoints(jax_tree, tmp_path):
    full, compact = jckpt.save_checkpoint(str(tmp_path), 7, jax_tree)
    with open(compact, "rb") as f:
        _assert_tree_equal(unpackb(f.read()), jax_tree)
    with open(full, "rb") as f:  # np.int64 step: an ext-3 scalar
        state = unpackb(f.read())
    assert state["step"] == 7
    _assert_tree_equal(state["params"], jax_tree)
    spec = _spec()
    loaded = tckpt.load_compact(str(tmp_path),
                                tcap.init_params(spec, device="cpu"))
    _assert_tree_equal(bridge.to_jax_tree(loaded), jax_tree)


def test_comic_tpu_reads_port_checkpoints(jax_tree, tmp_path):
    state = bridge.from_jax_tree(jax_tree, "cpu")
    path = tckpt.save_compact(str(tmp_path), 3, state)
    assert os.path.basename(path) == "model_compact-3.msgpack"
    with open(path, "rb") as f:
        data = f.read()
    _assert_tree_equal(serialization.msgpack_restore(data), jax_tree)
    _assert_tree_equal(jckpt.load_compact(path, jax_tree), jax_tree)


def test_bridge_round_trip_and_tree(jax_tree):
    state = bridge.from_jax_tree(jax_tree, "cpu")
    conv = state["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"]
    assert tuple(conv.shape) == (64, 3, 7, 7)  # HWIO -> OIHW
    np.testing.assert_array_equal(
        conv.permute(2, 3, 1, 0).numpy(),
        jax_tree["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"])
    _assert_tree_equal(bridge.to_jax_tree(state), jax_tree)
    # the port's own init has comic_tpu's keys and shapes
    ours = bridge.to_jax_tree(tcap.init_params(_spec(), device="cpu"))
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(jax_tree))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(jax_tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_load_compact_refuses_other_models(jax_tree, tmp_path):
    tckpt.save_compact(str(tmp_path), 1, bridge.from_jax_tree(jax_tree,
                                                              "cpu"))
    other = tcap.build_model_spec(Config(**dict(SMALL, rnn_size=64)),
                                  Vocabulary(dict(WTOI)))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_compact(str(tmp_path), tcap.init_params(other,
                                                           device="cpu"))
    # a TF checkpoint restores only into a full model tree, and an Orbax
    # directory without its metadata holds no tree: both refused, as
    # comic_tpu refuses them
    for suffix, error, match in ((".index", ValueError, "not a full model"),
                                 (".orbax", FileNotFoundError,
                                  "No structure")):
        d = tmp_path / suffix[1:]
        d.mkdir()
        if suffix == ".orbax":
            (d / "model_compact-2.orbax").mkdir()
        else:
            (d / "model_compact-2.index").write_bytes(b"")
        for load in (tckpt.load_compact, jckpt.load_compact):
            with pytest.raises(error, match=match):
                load(str(d), {})


def test_listing_matches_comic_tpu(tmp_path):
    for n in (1, 2, 10, 9, 30):
        (tmp_path / f"model_compact-{n}.msgpack").write_bytes(b"")
    (tmp_path / "model_compact-5.index").write_bytes(b"")
    (tmp_path / "model-9.msgpack").write_bytes(b"")
    (tmp_path / "notes.txt").write_bytes(b"")
    d = str(tmp_path)
    assert tckpt.list_checkpoints(d) == jckpt.list_checkpoints(d)
    assert tckpt.list_checkpoints(d, tckpt.FULL_PREFIX) == \
        jckpt.list_checkpoints(d, jckpt.FULL_PREFIX)
    assert tckpt.select_eval_checkpoints(d, cap=2, threshold=3) == \
        jckpt.select_eval_checkpoints(d, cap=2, threshold=3)
    for q in (d, os.path.join(d, "model_compact-10"),
              os.path.join(d, "model_compact-5")):
        assert tckpt._resolve(q, tckpt.COMPACT_PREFIX) == \
            jckpt._resolve(q, jckpt.COMPACT_PREFIX)
    with pytest.raises(FileNotFoundError):
        tckpt._resolve(os.path.join(d, "missing"), tckpt.COMPACT_PREFIX)


# --- the training side: retention, the saver, the restore modes -------------

def _scaled(tree, s):
    return jax.tree_util.tree_map(lambda x: (x * s).astype(x.dtype), tree)


@pytest.mark.parametrize("max_saves", [1, 3])
def test_retention_matches_comic_tpu(jax_tree, tmp_path, max_saves):
    """Full and compact checkpoints of steps 1..5 through the port's
    AsyncCheckpointer and comic_tpu's save_checkpoint leave the same files
    (2 full, ``max_saves`` compact); a reference TF checkpoint in the
    directory takes no slot and stays."""
    state = bridge.from_jax_tree(jax_tree, "cpu")
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        d.mkdir()
        (d / "model_compact-100.index").write_bytes(b"")
    saver = tckpt.make_saver("msgpack")
    for step in range(1, 6):
        saver.save(str(port), step, state, {"0": {}}, max_saves=max_saves)
        jckpt.save_checkpoint(str(ref), step, jax_tree, {"0": {}},
                              max_saves=max_saves)
    saver.close()
    saver.close()  # idempotent
    with pytest.raises(RuntimeError):
        saver.save(str(port), 6, state)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert "model_compact-100.index" in os.listdir(port)
    assert len([f for f in os.listdir(port) if f.startswith("model-")]) == 2
    for name in os.listdir(ref):
        if name.endswith(".msgpack"):
            with open(port / name, "rb") as a, open(ref / name, "rb") as b:
                assert a.read() == b.read()
    orbax = tckpt.make_saver("orbax")  # test_torch_orbax.py holds its files
    orbax.close()
    with pytest.raises(ValueError, match="Unknown checkpoint backend"):
        tckpt.make_saver("zarr")


def test_restore_modes_match_comic_tpu(jax_tree, tmp_path):
    """scratch, model (with checkpoint_exclude_scopes) and cnn restores
    give comic_tpu's trees, modes and steps."""
    spec = _spec()
    init_t = tcap.init_params(spec, device="cpu")
    init_j = bridge.to_jax_tree(init_t)
    saved = _scaled(jax_tree, 2.0)
    d = str(tmp_path / "run")
    jckpt.save_checkpoint(d, 4, saved)
    cnn_file = str(tmp_path / "cnn.msgpack")
    tckpt.save_cnn_checkpoint(
        cnn_file, bridge.from_jax_tree(saved, "cpu")["encoder"]["cnn"])
    cases = [(None, None), (d, None), (d, "Model/decoder/attention"),
             (d, "decoder/cell,encoder/cnn/Mixed_5"), (cnn_file, None),
             (cnn_file, "Conv2d_1a_7x7")]
    for path, excl in cases:
        got, step, mode = tckpt.restore_model(init_t, path,
                                              exclude_scopes=excl)
        want, _, jstep, jmode = jckpt.restore_model(init_j, path,
                                                    exclude_scopes=excl)
        assert (mode, step) == (jmode, jstep)
        _assert_tree_equal(bridge.to_jax_tree(got),
                           jax.tree_util.tree_map(np.asarray, want))
    assert [tckpt.restore_model(init_t, p)[2] for p in (None, d, cnn_file)] \
        == ["scratch", "model", "cnn"]
    # an excluded scope keeps its initial values, the rest is restored
    got, _, _ = tckpt.restore_model(init_t, d,
                                    exclude_scopes="decoder/attention")
    assert torch.equal(got["decoder"]["attention"]["v"],
                       init_t["decoder"]["attention"]["v"])
    np.testing.assert_array_equal(
        got["decoder"]["cell"]["kernel"].numpy(),
        saved["decoder"]["cell"]["kernel"])


def test_restore_refuses_what_does_not_fit(jax_tree, tmp_path):
    spec = tcap.build_model_spec(Config(**dict(SMALL, rnn_size=64)),
                                 Vocabulary(dict(WTOI)))
    jckpt.save_checkpoint(str(tmp_path), 2, jax_tree)
    with pytest.raises(ValueError, match="CNN-only fallback"):
        tckpt.restore_model(tcap.init_params(spec, device="cpu"),
                            str(tmp_path))
    # an Orbax compact checkpoint of another model fails both branches too
    saver = tckpt.make_saver("orbax")
    saver.save(str(tmp_path / "orbax"), 3,
               bridge.from_jax_tree(jax_tree, "cpu"))
    saver.close()
    with pytest.raises(ValueError, match="CNN-only fallback"):
        tckpt.restore_model(tcap.init_params(spec, device="cpu"),
                            str(tmp_path / "orbax"))
