"""comic_tpu_torch's synthetic fixture, utils/io, natural sort and
checkpoint_step against comic_tpu's on the CPU: the fixture's files byte
for byte (JPEGs included, under one PIL), the archive helpers on local
files and a file:// URL (nothing here reaches a network)."""

import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from comic_tpu.data import synthetic as jsyn
from comic_tpu.training import checkpoints as jckpt
from comic_tpu.utils import io as jio
from comic_tpu.utils import natural_sort as jns
from comic_tpu_torch.data import synthetic as tsyn
from comic_tpu_torch.training import checkpoints as tckpt
from comic_tpu_torch.utils import io as tio
from comic_tpu_torch.utils import natural_sort as tns

torch.set_num_threads(1)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(style="insta", num_train=6, num_valid=3, num_test=2, seed=4),
    dict(num_train=10, num_valid=4, num_test=4, captions_per_image=1,
         test_mirrors_train=True, distinct_images=True),
    dict(style="insta", num_train=5, test_mirrors_train=True,
         distinct_images=True, image_size=64, pattern="x_{}", seed=9),
])
def test_fixture_is_byte_identical(tmp_path, kw):
    jroot, jvocab = jsyn.make_synthetic_dataset(str(tmp_path / "jax"), **kw)
    troot, tvocab = tsyn.make_synthetic_dataset(str(tmp_path / "port"), **kw)
    want, got = _files(jroot), _files(troot)
    assert sorted(got) == sorted(want)
    n_images = sum(1 for k in want if k.startswith("images"))
    assert n_images == sum(kw.get(k, d) for k, d in (
        ("num_train", 32), ("num_valid", 8), ("num_test", 8)))
    for name in want:
        assert got[name] == want[name], name
    assert tvocab.wtoi == jvocab.wtoi


def test_drawing_needs_no_image_library(tmp_path):
    """draw_synthetic_dataset + write_caption_artifacts give the fixture's
    records, its image arrays and every file but the JPEGs, without PIL."""
    kw = dict(num_train=10, num_valid=4, num_test=4, captions_per_image=1,
              test_mirrors_train=True, distinct_images=True)
    data = tsyn.draw_synthetic_dataset(**kw)
    tsyn.write_caption_artifacts(str(tmp_path / "mem"), data)
    tsyn.make_synthetic_dataset(str(tmp_path / "disk"), **kw)
    want = {k: v for k, v in _files(str(tmp_path / "disk")).items()
            if not k.startswith("images")}
    assert _files(str(tmp_path / "mem")) == want
    assert data.records["test"] == data.records["train"]
    assert len(data.records["train"]) == 10
    assert sorted(data.images) == sorted(
        "images/" + n for n in os.listdir(tmp_path / "disk" / "images"))
    arr = data.images["images/COCO_synth_000000000000.jpg"]
    assert arr.shape == (256, 256, 3) and arr.dtype == np.uint8
    # a solid colour within the +-20 noise
    assert np.ptp(arr.reshape(-1, 3).astype(int), axis=0).max() <= 40


def test_missing_pil_raises_naming_it(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="'PIL'"):
        tsyn.make_synthetic_dataset(str(tmp_path), num_train=1, num_valid=1,
                                    num_test=1)


def test_natural_sort_and_checkpoint_step_match_comic_tpu():
    names = ["model_compact-10", "model_compact-9", "Model_compact-100",
             "a2b10", "a2b9", "x", "", "model-1", "model_compact-09"]
    assert tns.natural_sorted(names) == jns.natural_sorted(names)
    for n in names + ["model_compact-12.msgpack", "step", "7"]:
        assert tns.natural_key(n) == jns.natural_key(n)
        assert tckpt.checkpoint_step(n) == jckpt.checkpoint_step(n)
    assert tckpt.checkpoint_step("model_compact-12") == 12
    assert tckpt.checkpoint_step("model") == -1


def _tar(path, members, mode="w:gz"):
    with tarfile.open(path, mode) as t:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("kind", ["tar.gz", "tar.bz2", "zip"])
def test_extract_archive_matches_comic_tpu(tmp_path, kind):
    members = {"ckpt/inception_v1.ckpt": b"weights", "ckpt/sub/x.txt": b"x"}
    src = str(tmp_path / f"a.{kind}")
    if kind == "zip":
        with zipfile.ZipFile(src, "w") as z:
            for name, data in members.items():
                z.writestr(name, data)
    else:
        _tar(src, members, "w:" + kind.split(".")[1])
    outs = [mod.extract_archive(src, str(tmp_path / name))
            for name, mod in (("jax", jio), ("port", tio))]
    assert _files(outs[0]) == _files(outs[1]) == members
    # the default output directory is the archive's own
    assert tio.extract_archive(src) == str(tmp_path)


def test_extract_archive_refuses_what_comic_tpu_refuses(tmp_path):
    evil = str(tmp_path / "evil.tar.gz")
    _tar(evil, {"../escaped.txt": b"no"})
    for mod in (jio, tio):
        with pytest.raises(tarfile.FilterError):
            mod.extract_archive(evil, str(tmp_path / "out"))
    assert not (tmp_path / "escaped.txt").exists()
    other = tmp_path / "plain.bin"
    other.write_bytes(b"not an archive")
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="Unknown archive format"):
            mod.extract_archive(str(other))


def test_maybe_download_local_and_file_url(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"payload" * 100)
    url = src.as_uri()  # file://, read from the local disk
    dest = str(tmp_path / "sub" / "dest.bin")
    # off by default: nothing fetched
    assert tio.maybe_download(url, dest) is None
    assert not os.path.exists(dest)
    assert tio.maybe_download(url, dest, allow_download=True) == dest
    with open(dest, "rb") as f:
        assert f.read() == src.read_bytes()
    assert not os.path.exists(dest + ".part")
    # an existing file is returned as it is, download or not
    src.write_bytes(b"changed")
    assert tio.maybe_download(url, dest) == dest
    with open(dest, "rb") as f:
        assert f.read() == b"payload" * 100
    jdest = str(tmp_path / "j" / "dest.bin")
    assert jio.maybe_download(url, jdest, allow_download=True) == jdest
