"""comic_tpu_torch.prepro against comic_tpu.prepro on the CPU: the coco,
insta and ngrams CLIs on seeded Karpathy-format and InstaPIC-format JSONs
that the tests write themselves (every artifact byte for byte), the V2
caption lines, and the packed HDF5 (dataset by dataset)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from comic_tpu.prepro import base as jbase
from comic_tpu.prepro import coco as jcoco
from comic_tpu.prepro import insta as jinsta
from comic_tpu.prepro import ngrams as jngrams
from comic_tpu_torch.prepro import base as tbase
from comic_tpu_torch.prepro import coco as tcoco
from comic_tpu_torch.prepro import insta as tinsta
from comic_tpu_torch.prepro import ngrams as tngrams

torch.set_num_threads(1)

WORDS = ["a", "A", "man", "Dog!", "cat,", "riding", "on", "the", "beach.",
         "café", "42nd", "_", "x_y", "red", "blue", "street", "of", "in",
         "park", "table", "'s", "--"]
SPLITS = ["train", "restval", "val", "test"]


def _karpathy_json(path, seed=0, n_images=40):
    """A seeded dataset_coco.json: images of every split, 1-6 sentences of
    1-25 tokens each (some longer than the length threshold)."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(n_images):
        split = SPLITS[int(rng.integers(len(SPLITS)))]
        sub = "train2014" if split == "train" else "val2014"
        sents = []
        for _ in range(int(rng.integers(1, 7))):
            toks = [WORDS[int(j)] for j in rng.integers(
                0, len(WORDS), int(rng.integers(1, 26)))]
            sents.append({"tokens": toks, "raw": " ".join(toks)})
        images.append({"filepath": sub,
                       "filename": f"COCO_{sub}_{i + 1:012d}.jpg",
                       "split": split, "cocoid": i + 1, "sentences": sents})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images}, f)


INSTA_PARTS = ["#sunset", "@some.user", "love", "this!!", "so-much", "\U0001F600",
               "☀", "beach", "with", "@friend_1", "#tbt", "the", "sea,",
               "\"best\"", "day", "ever?", "x - y", "\n"]


def _insta_json(directory, seed=0):
    """Seeded InstaPIC train and test1 JSONs: {user: {post: {caption}}}."""
    rng = np.random.default_rng(seed)

    def posts(n_users, tag):
        out = {}
        for u in range(n_users):
            out[f"{tag}user{u}"] = {
                f"p{p}": {"caption": " ".join(
                    INSTA_PARTS[int(j)] for j in rng.integers(
                        0, len(INSTA_PARTS), int(rng.integers(2, 20))))}
                for p in range(int(rng.integers(1, 5)))}
        return out

    os.makedirs(os.path.join(directory, "json"), exist_ok=True)
    for name, n, tag in (("insta-caption-train.json", 12, "tr"),
                         ("insta-caption-test1.json", 4, "te")):
        with open(os.path.join(directory, "json", name), "w") as f:
            json.dump(posts(n, tag), f)


def _assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _twin_dirs(tmp_path, make):
    """The same input written into two dataset directories."""
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    make(dirs[0])
    shutil.copytree(dirs[0], dirs[1])
    return dirs


@pytest.mark.parametrize("argv", [
    [],
    ["--include_restval=", "--word_count_thres", "1"],
    ["--caption_len_thres", "8", "--output_prefix", "coco"],
])
def test_coco_cli_matches_comic_tpu(tmp_path, argv):
    jdir, tdir = _twin_dirs(tmp_path, lambda d: _karpathy_json(
        os.path.join(d, "dataset_coco.json")))
    jcounts, jvocab = jcoco.main(["--dataset_dir", jdir] + argv)
    tcounts, tvocab = tcoco.main(["--dataset_dir", tdir] + argv)
    assert tcounts == jcounts and tvocab.wtoi == jvocab.wtoi
    _assert_same_files(os.path.join(jdir, "captions"),
                       os.path.join(tdir, "captions"))


def test_ngrams_cli_matches_comic_tpu(tmp_path):
    jdir, tdir = _twin_dirs(tmp_path, lambda d: _karpathy_json(
        os.path.join(d, "dataset_coco.json"), seed=3))
    jcoco.main(["--dataset_dir", jdir])
    tcoco.main(["--dataset_dir", tdir])
    jout = jngrams.main(["--dataset_dir", jdir])
    tout = tngrams.main(["--dataset_dir", tdir])
    assert os.path.basename(tout) == os.path.basename(jout) \
        == "mscoco_scst-words_w5_s20_include_restval.p"
    _assert_same_files(os.path.join(jdir, "captions"),
                       os.path.join(tdir, "captions"))


@pytest.mark.parametrize("argv", [[], ["--num_valid", "5", "--vocab_size",
                                       "30", "--caption_len_thres", "6"]])
def test_insta_cli_matches_comic_tpu(tmp_path, argv):
    jdir, tdir = _twin_dirs(tmp_path, _insta_json)
    jcounts, jvocab = jinsta.main(["--dataset_dir", jdir] + argv)
    tcounts, tvocab = tinsta.main(["--dataset_dir", tdir] + argv)
    assert tcounts == jcounts and tvocab.wtoi == jvocab.wtoi
    _assert_same_files(os.path.join(jdir, "captions"),
                       os.path.join(tdir, "captions"))


def _parser_view(parser):
    return [(a.dest, a.default, a.type, a.required, a.help)
            for a in parser._actions]


def test_parsers_match_comic_tpu():
    """Flags and defaults, including coco's type=bool --include_restval:
    any non-empty value is true, the empty string false."""
    for j, t in ((jcoco, tcoco), (jinsta, tinsta), (jngrams, tngrams)):
        assert _parser_view(t.create_parser()) == \
            _parser_view(j.create_parser())
    parse = tcoco.create_parser().parse_args
    assert parse(["--dataset_dir", "d"]).include_restval is True
    assert parse(["--dataset_dir", "d", "--include_restval",
                  "False"]).include_restval is True
    assert parse(["--dataset_dir", "d",
                  "--include_restval="]).include_restval is False


def test_tokenisers_match_comic_tpu(tmp_path):
    path = str(tmp_path / "k.json")
    _karpathy_json(path, seed=5)
    assert tbase.tokenise_karpathy(path) == jbase.tokenise_karpathy(path)
    assert tbase.tokenise_karpathy(path, {"val2014": "v"}) == \
        jbase.tokenise_karpathy(path, {"val2014": "v"})
    for part in INSTA_PARTS + [" ".join(INSTA_PARTS), INSTA_PARTS]:
        assert tinsta.tokenize(part) == jinsta.tokenize(part)
    assert tbase.clean_tokens(WORDS) == jbase.clean_tokens(WORDS)
    for split in SPLITS + ["other"]:
        for inc in (True, False):
            assert tbase.convert_split(split, inc) == \
                jbase.convert_split(split, inc)


@pytest.mark.parametrize("thres", [20, 5])
def test_txt_v2_matches_comic_tpu(tmp_path, thres):
    path = str(tmp_path / "k.json")
    _karpathy_json(path, seed=7)
    ds = jbase.tokenise_karpathy(path)
    for inc in (True, False):
        assert tbase.tokenised_word_to_txt_v2(ds, thres, inc) == \
            jbase.tokenised_word_to_txt_v2(ds, thres, inc)


def test_split_overlap_is_refused(tmp_path):
    """write_caption_txts asserts the splits are disjoint, as comic_tpu's
    does (coco_prepro.py:140-146)."""
    ds = [tbase.TokenisedImage(filepath="a.jpg", split="train", image_id=1,
                               tokens=[["a"]]),
          tbase.TokenisedImage(filepath="a.jpg", split="test", image_id=1,
                               tokens=[["b"]])]
    with pytest.raises(AssertionError):
        tbase.write_caption_txts(ds, str(tmp_path), "p_{}")


def _pack_inputs(tmp_path):
    """Seeded images of several sizes and a V2 line dict over them."""
    pytest.importorskip("PIL")
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(11)
    ds = []
    for i, split in enumerate(["train", "train", "val", "test", "restval",
                               "test"]):
        name = f"im{i}.png"
        arr = rng.integers(0, 256, (30 + 7 * i, 41 + 3 * i, 3),
                           dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / name)
        ds.append(tbase.TokenisedImage(
            filepath=name, split=split, image_id=i,
            tokens=[list(rng.choice(["a", "b", "c"], 1 + i))] * (1 + i % 2)))
    lines = jbase.tokenised_word_to_txt_v2(ds)
    wtoi = {"<PAD>": -1, "a": 0, "b": 1, "c": 2, "<UNK>": 3, "<GO>": 4,
            "<EOS>": 5}
    itow = {str(v): k for k, v in wtoi.items()}
    return str(img_dir), lines, wtoi, itow


def test_pack_matches_comic_tpu(tmp_path):
    """serialise_everything: the same datasets (names, dtypes, shapes,
    chunks, values) from both packages; load_h5_dataset reads both the
    same."""
    h5py = pytest.importorskip("h5py")
    img_dir, lines, wtoi, itow = _pack_inputs(tmp_path)
    paths = [mod.serialise_everything(str(tmp_path / name), img_dir,
                                      (24, 32), 2, lines, wtoi, itow)
             for name, mod in (("jax", jbase), ("port", tbase))]
    with h5py.File(paths[0], "r") as fj, h5py.File(paths[1], "r") as ft:
        assert sorted(fj) == sorted(ft)
        for name in fj:
            a, b = fj[name], ft[name]
            assert (a.dtype, a.shape, a.chunks) == (b.dtype, b.shape,
                                                    b.chunks), name
            np.testing.assert_array_equal(a[()], b[()], err_msg=name)
    for max_images in (None, 0, 2):
        got = tbase.load_h5_dataset(paths[1], max_images)
        want = jbase.load_h5_dataset(paths[0], max_images)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "images":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k
