"""comic_tpu_torch's training inputs against comic_tpu's on the CPU: the
encode side of the tokenization, the vocabulary and config records, the
caption files, the train augment at comic_tpu's own draws, train-time
dropout, the parameter helpers, and TrainPipeline's batches, widths and
order over two epochs of the synthetic dataset."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comic_tpu import configuration as jconf
from comic_tpu import tokenization as jtok
from comic_tpu.data import captions as jcap_io
from comic_tpu.data import pipeline as jpipe
from comic_tpu.data import preprocessing as jprep
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.models import cells as jcells
from comic_tpu.models import layers as jlayers
from comic_tpu_torch import configuration as tconf
from comic_tpu_torch import params as bridge
from comic_tpu_torch import tokenization as ttok
from comic_tpu_torch.data import captions as tcap_io
from comic_tpu_torch.data import pipeline as tpipe
from comic_tpu_torch.data import preprocessing as tprep
from comic_tpu_torch.models import cells as tcells
from comic_tpu_torch.models import layers as tlayers

torch.set_num_threads(1)

WORDS = ["a", "man", "dog", "on", "the", "beach", "riding", "red"]


def _token_lists(rng, n):
    return [[WORDS[i] for i in rng.integers(0, len(WORDS),
                                            int(rng.integers(2, 12)))]
            + (["zebra"] if k % 3 == 0 else []) for k in range(n)]


# --- tokenization and vocabulary -------------------------------------------

@pytest.mark.parametrize("kw", [dict(word_count_thres=1),
                                dict(word_count_thres=3),
                                dict(vocab_size=4, caption_len_thres=5)])
def test_build_vocab_matches(kw):
    lists = _token_lists(np.random.default_rng(0), 40)
    want, got = jtok.build_vocab(lists, **kw), ttok.build_vocab(lists, **kw)
    assert got.wtoi == want.wtoi and got.itow == want.itow
    assert (got.pad_id, got.unk_id, got.go_id, got.eos_id) == (
        want.pad_id, want.unk_id, want.go_id, want.eos_id)
    assert got.id("zebra-not-there") == want.id("zebra-not-there")
    assert [got.word(i) for i in got.itow] == [want.word(i)
                                                for i in want.itow]
    c_want, c_got = jtok.build_char_vocab(), ttok.build_char_vocab()
    assert c_got.wtoi == c_want.wtoi and c_got.itow == c_want.itow


def test_vocab_files_load_in_both_packages(tmp_path):
    v = ttok.build_vocab(_token_lists(np.random.default_rng(1), 30),
                         word_count_thres=1)
    w, i = str(tmp_path / "wtoi.json"), str(tmp_path / "itow.json")
    v.save(w, i)
    back = jtok.Vocabulary.load(w, i)
    assert back.wtoi == v.wtoi and back.itow == v.itow
    jtok.Vocabulary.load(w, i).save(w, i)
    again = ttok.Vocabulary.load(w, i)
    assert again.wtoi == v.wtoi and again.itow == v.itow


@pytest.mark.parametrize("token_type,base", [("word", None), ("radix", 4),
                                             ("radix", 256), ("char", None)])
def test_encode_caption_tokens_matches(token_type, base):
    lists = _token_lists(np.random.default_rng(2), 20)
    jv = jtok.build_vocab(lists, word_count_thres=2)
    tv = ttok.build_vocab(lists, word_count_thres=2)
    if token_type == "char":
        jv, tv = jtok.build_char_vocab(), ttok.build_char_vocab()
    if token_type == "radix":
        assert tv.radix_map(base) == jv.radix_map(base)
        jc, tc = jtok.RadixCodec(len(jv), base), ttok.RadixCodec(len(tv), base)
        for wid in (0, 1, len(tv) - 1, base - 1):
            assert tc.encode_word_id(wid) == jc.encode_word_id(wid)
        assert tc.build_radix_wtoi(tv.wtoi) == jc.build_radix_wtoi(jv.wtoi)
    for toks in lists:
        toks = ["<GO>"] + toks + ["<EOS>"]
        got = ttok.encode_caption_tokens(toks, token_type, tv, base)
        want = jtok.encode_caption_tokens(toks, token_type, jv, base)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# --- config record and caption files ----------------------------------------

def test_config_pkl_loads_in_both_packages(tmp_path):
    kw = dict(rnn_size=64, attn_num_heads=2, wtoi={"<PAD>": -1, "a": 0},
              itow={"0": "a"}, cnn_input_size=(64, 64), max_step=17)
    for save_cls, name in ((tconf.Config, "port"), (jconf.Config, "jax")):
        d = str(tmp_path / name)
        pkl = save_cls(log_path=d, **kw).save(d)
        with open(pkl, "rb") as f:
            assert pickle.load(f)["_comic_tpu_config_version"] == \
                tconf.CONFIG_VERSION == jconf.CONFIG_VERSION
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        assert any(f.startswith("config___") for f in os.listdir(d))
        a, b = tconf.load_config(d), jconf.load_config(d)
        assert a.to_dict() == b.to_dict()
        assert a.rnn_size == 64 and tuple(a.cnn_input_size) == (64, 64)
        cfg = tconf.Config(log_path=d)
        with pytest.raises(FileExistsError):
            cfg.overwrite_safety_check(overwrite=False)
        cfg.overwrite_safety_check(overwrite=True)
        tconf.Config(log_path=d, resume_training=True) \
            .overwrite_safety_check(overwrite=False)
        tconf.Config(log_path=str(tmp_path / "new")) \
            .overwrite_safety_check(overwrite=False)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    data, _ = make_synthetic_dataset(root, num_train=24, num_valid=6,
                                     num_test=4, captions_per_image=2,
                                     image_size=64)
    return data


def test_caption_files_match(synth):
    for split in ("train", "valid"):
        path = tcap_io.caption_file_path(synth, "synth_{}", split)
        assert path == jcap_io.caption_file_path(synth, "synth_{}", split)
        recs = tcap_io.read_caption_file(path)
        assert recs == jcap_io.read_caption_file(path)
        for cap in (1, 5):
            assert tcap_io.group_by_image(recs, cap) == \
                jcap_io.group_by_image(recs, cap)
    with pytest.raises(ValueError):
        tcap_io.caption_file_path(synth, "no_braces", "train")
    tv, jv = (tcap_io.load_vocab(synth, "synth_{}"),
              jcap_io.load_vocab(synth, "synth_{}"))
    assert tv.wtoi == jv.wtoi and tv.itow == jv.itow


# --- augment, dropout, parameter helpers ------------------------------------

def test_augment_matches_comic_tpu_draws():
    """The port's augment at the flips and offsets comic_tpu's
    _augment_one draws from its key gives comic_tpu's batch exactly."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (5, 40, 36, 3), dtype=np.uint8)
    out_h, out_w = 24, 20
    key = jax.random.PRNGKey(11)
    want = np.asarray(jprep.preprocess_batch(jnp.asarray(images), key,
                                             out_h, out_w, True))
    flips, oy, ox = [], [], []
    for k in jax.random.split(key, images.shape[0]):
        k_flip, k_y, k_x = jax.random.split(k, 3)
        flips.append(bool(jax.random.bernoulli(k_flip)))
        oy.append(int(jax.random.randint(k_y, (), 0, 40 - out_h + 1)))
        ox.append(int(jax.random.randint(k_x, (), 0, 36 - out_w + 1)))
    assert any(flips) and not all(flips)
    got = tprep.augment(torch.from_numpy(images), out_h, out_w,
                        torch.tensor(flips), torch.tensor(oy),
                        torch.tensor(ox))
    got = got.float() * (2.0 / 255.0) - 1.0
    # comic_tpu computes (x / 255 - .5) * 2, the port x * (2/255) - 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_augment_draws_cover_every_offset():
    g = torch.Generator().manual_seed(0)
    flips, oy, ox = tprep.draw_augment(g, 4000, 256, 256, 224, 224)
    assert abs(flips.float().mean().item() - 0.5) < 0.03
    assert oy.min().item() == 0 and oy.max().item() == 32
    assert ox.min().item() == 0 and ox.max().item() == 32
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 256, 256, 3), dtype=np.uint8))
    a = tprep.preprocess_batch(x, 224, 224, torch.device("cpu"),
                               training=True,
                               generator=torch.Generator().manual_seed(5))
    b = tprep.preprocess_batch(x, 224, 224, torch.device("cpu"),
                               training=True,
                               generator=torch.Generator().manual_seed(5))
    assert a.shape == (3, 3, 224, 224) and torch.equal(a, b)


@pytest.mark.parametrize("variational", [False, True])
def test_apply_dropout_matches(variational):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 10)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    keep = 0.65
    if variational:
        noise = np.where(rng.random((6, 10)) < keep, 1 / keep,
                         0.0).astype(np.float32)
        want = jcells.apply_dropout(None, jnp.asarray(x), keep, False,
                                    noise=jnp.asarray(noise))
        got = tcells.apply_dropout(torch.from_numpy(x), keep,
                                   noise=torch.from_numpy(noise))
    else:
        want = jcells.apply_dropout(key, jnp.asarray(x), keep, False)
        mask = np.array(jax.random.bernoulli(key, keep, x.shape))
        got = tcells.apply_dropout(torch.from_numpy(x), keep,
                                   keep_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tcells.apply_dropout(torch.from_numpy(x), 1.0) is not None
    drawn = tcells.apply_dropout(torch.ones(4000), 0.8,
                                 generator=torch.Generator().manual_seed(0))
    assert set(drawn.unique().tolist()) == {0.0, float(np.float32(1 / 0.8))}


def test_count_params_and_l2_loss_match():
    rng = np.random.default_rng(5)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "c": rng.normal(size=(2, 2, 3, 5)).astype(np.float32)}
    ttree = bridge.from_jax_tree({"x": tree}, "cpu")
    assert tlayers.count_params(ttree) == jlayers.count_params(tree) == 76
    for decay in (0.0, 1e-3):
        np.testing.assert_allclose(
            float(tlayers.l2_loss(ttree, decay)),
            float(jlayers.l2_loss(tree, decay)), rtol=1e-6)


# --- the training pipeline ---------------------------------------------------

def _configs(data, **kw):
    base = dict(token_type="radix", radix_base=4, dataset_dir=data,
                dataset_file_pattern="synth_{}", batch_size_train=4,
                batch_size_eval=3, max_epoch=3, rand_seed=7)
    base.update(kw)
    return jconf.Config(**base), tconf.Config(**base)


@pytest.mark.parametrize("token_type", ["radix", "word"])
def test_train_pipeline_matches_for_two_epochs(synth, token_type):
    """The same batches (images, caption ids, bucket widths) in the same
    order as comic_tpu's for two epochs of iter(pipe), and the same eval
    epoch; the derived config fields agree."""
    jc, tc = _configs(synth, token_type=token_type)
    jv = jcap_io.load_vocab(synth, "synth_{}")
    tv = tcap_io.load_vocab(synth, "synth_{}")
    jp = jpipe.TrainPipeline(jc, jv, "train", num_workers=2)
    tp = tpipe.TrainPipeline(tc, tv, "train", num_workers=2)
    try:
        assert tp.bounds == jp.bounds
        assert tp.steps_per_epoch == jp.steps_per_epoch == 12
        assert tc.max_step == jc.max_step == 36
        assert tc.split_sizes == jc.split_sizes
        widths = set()
        jit, tit = iter(jp), iter(tp)
        for _ in range(2 * 12):
            (ji, jcap), (ti, tcap) = next(jit), next(tit)
            np.testing.assert_array_equal(tcap, jcap)
            np.testing.assert_array_equal(ti, ji)
            assert tcap.dtype == np.int32 and ti.dtype == np.uint8
            widths.add(tcap.shape[1])
        assert len(widths) > 1  # more than one bucket was drawn
    finally:
        tp.close()
    jpe = jpipe.TrainPipeline(jc, jv, "valid", num_workers=2)
    tpe = tpipe.TrainPipeline(tc, tv, "valid", num_workers=2)
    try:
        got, want = list(tpe.epoch()), list(jpe.epoch())
        assert len(got) == len(want) == 2
        for (ti, tcap), (ji, jcap) in zip(got, want):
            np.testing.assert_array_equal(tcap, jcap)
            np.testing.assert_array_equal(ti, ji)
    finally:
        tpe.close()


def test_bucket_helpers_match(synth):
    for token_type, pattern in (("radix", "synth_{}"), ("word", "insta_{}"),
                                ("char", "synth_{}")):
        jc, tc = _configs(synth, token_type=token_type,
                          dataset_file_pattern=pattern)
        v = jtok.build_vocab([WORDS], word_count_thres=1)
        tv = ttok.build_vocab([WORDS], word_count_thres=1)
        for m in (None, 90):
            assert tpipe.bucket_boundaries(tc, tv, max_encoded_len=m) == \
                jpipe.bucket_boundaries(jc, v, max_encoded_len=m)
    bounds = [3, 5, 9]
    for n in range(12):
        assert tpipe.pick_bucket(n, bounds) == jpipe.pick_bucket(n, bounds)
    rows = [np.arange(k, dtype=np.int32) for k in (1, 4, 7)]
    np.testing.assert_array_equal(tpipe.pad_rows(rows, 5),
                                  jpipe.pad_rows(rows, 5))
    for cnn, modes in (("inception_v1", ("square", "square")),
                       ("mobilenet_v2", ("square", "square")),
                       ("vgg_16", ("aspect_train", "aspect_eval")),
                       ("resnet_v2_50", ("aspect_train", "aspect_eval"))):
        jc, tc = _configs(synth, cnn_name=cnn)
        for training, mode in zip((True, False), modes):
            assert tpipe.host_resize_mode(tc, training) == \
                jpipe.host_resize_mode(jc, training) == mode


def test_pipelines_refuse_what_is_not_ported(synth, monkeypatch):
    """The VGG/ResNet host modes are ported: the pipelines build loaders in
    comic_tpu's modes, seeded from the config; what stays refused is an
    eval batch that does not tile its split. In a multi-process job (rank
    1 of 2) the training split is split as comic_tpu splits it: global
    batch counts, and the rank's block of a global batch with the global
    batch's width."""
    jc, tc = _configs(synth, cnn_name="vgg_16")
    tv = tcap_io.load_vocab(synth, "synth_{}")
    for split, mode in (("train", "aspect_train"), ("valid", "aspect_eval")):
        tp = tpipe.TrainPipeline(tc, tv, split)
        jp = jpipe.TrainPipeline(jc, jcap_io.load_vocab(synth, "synth_{}"),
                                 split)
        assert tp.loader.mode == jp.loader.mode == mode
        tp.close()
    scst = tpipe.ScstPipeline(tc, tv)
    assert scst.loader.mode == "aspect_train"
    scst.close()
    _, tc = _configs(synth, batch_size_eval=4)
    with pytest.raises(ValueError, match="divide"):
        tpipe.TrainPipeline(tc, tv, "valid")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    jc, tc = _configs(synth, batch_size_train=2)
    tp = tpipe.TrainPipeline(tc, tv, "train")
    jp = jpipe.TrainPipeline(jc, jcap_io.load_vocab(synth, "synth_{}"),
                             "train")
    assert (tp.steps_per_epoch, tc.max_step) == (jp.steps_per_epoch,
                                                 jc.max_step)
    assert tp.steps_per_epoch == len(tp.records) // 4
    idxs = next(jp._batches_of_indices())
    assert len(idxs) == 4
    for got, want in zip(tp._make_batch(idxs), jp._make_batch(idxs)):
        assert got.shape[0] == 2
        np.testing.assert_array_equal(got, want)
    tp.close()
