"""Both packages' native CIDEr-D scorers, made loadable without a race.

comic_tpu compiles ``native/build/libciderd.so`` straight to its final path
on first use (comic_tpu/evaluation/cider_native.py:36-64). When several
test processes start at once on a tree without that file, one of them can
load a half-written library; comic_tpu then gives up on the native scorer
for the rest of that process and scores with the Python CIDEr-D, which
differs from the native one in the last bit of some per-image scores. A
test that compares comic_tpu's score files with the port's byte for byte
would then compare two implementations.

``build_native_library`` builds comic_tpu's library with comic_tpu's own
g++ line under an ``fcntl.flock``, into a temporary file that is renamed
into place. The session fixture ``native_ciderd`` runs it and makes
comic_tpu load the library again; the ``ciderd_used`` fixture records which
CIDEr-D each package's scoring built, so that the byte-identity tests can
assert that both sides ran the native scorer.
"""

import fcntl
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from comic_tpu.evaluation import cider_native as jnative
from comic_tpu.evaluation import coco_eval as jcoco
from comic_tpu.evaluation import scorers as jscorers
from comic_tpu_torch.evaluation import cider_native as tnative
from comic_tpu_torch.evaluation import coco_eval as tcoco
from comic_tpu_torch.evaluation import scorers as tscorers

# comic_tpu's command line (cider_native.py:47-49), output to a temp file
GXX = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC")


def _fresh(src: str, lib: str) -> bool:
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src))


def build_native_library(src: str = jnative._SRC, lib: str = jnative._LIB,
                         force: bool = False) -> bool:
    """Build ``lib`` from ``src`` unless it is there and newer (or
    ``force``), holding an exclusive flock on ``.lock`` beside it, into
    ``{lib}.{pid}.tmp`` and then ``os.replace``: the path never names a
    half-written file. -> whether this call compiled. A failing g++
    raises with its output."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(os.path.join(os.path.dirname(lib), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(src, lib) and not force:
            return False
        tmp = f"{lib}.{os.getpid()}.tmp"
        run = subprocess.run([*GXX, src, "-o", tmp], capture_output=True,
                             text=True)
        if run.returncode:
            raise RuntimeError(f"g++ could not build {lib}: {run.stderr}")
        os.replace(tmp, lib)
        return True


@pytest.fixture(scope="session")
def native_ciderd():
    """comic_tpu's native library built without a race and loaded by
    comic_tpu (its earlier failure in this process forgotten), and the
    port's loaded; both are asserted."""
    build_native_library()
    for _ in range(3):
        jnative._lib, jnative._build_failed = None, False
        if jnative.native_available():
            break
        # a comic_tpu process outside the lock rewrote the file while it
        # was loaded here: build it again
        build_native_library(force=True)
    assert jnative.native_available(), "comic_tpu's native CIDEr-D"
    assert tnative.native_available(), tnative.build_error()


@pytest.fixture
def ciderd_used(native_ciderd, monkeypatch):
    """{"jax": [...], "torch": [...]}: for each CIDEr-D that a package's
    coco_eval or scorers built from here on, whether it was native."""
    used = {"jax": [], "torch": []}
    for pkg, native_cls, modules in (
            ("jax", jnative.NativeCiderD, (jcoco, jscorers)),
            ("torch", tnative.NativeCiderD, (tcoco, tscorers))):
        for mod in modules:
            def spy(*args, _make=mod.make_ciderd, _pkg=pkg, _cls=native_cls,
                    **kwargs):
                scorer = _make(*args, **kwargs)
                used[_pkg].append(isinstance(scorer, _cls))
                return scorer

            monkeypatch.setattr(mod, "make_ciderd", spy)
    return used


def assert_both_native(used):
    """Both packages built CIDEr-D scorers, and every one was native."""
    assert used["jax"] and all(used["jax"]), used
    assert used["torch"] and all(used["torch"]), used


def test_both_native_scorers_load_and_agree_bitwise(ciderd_used):
    assert os.path.exists(jnative._LIB)
    gts = {i: [f"a dog {w} on the beach", f"the {w} runs"]
           for i, w in enumerate(["cat", "man", "dog", "bike", "red"])}
    res = {i: [f"a {w} on a beach"]
           for i, w in enumerate(["dog", "man", "cat", "car", "red"])}
    want = jcoco.make_ciderd().compute_score(gts, res)
    got = tcoco.make_ciderd().compute_score(gts, res)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(want[1]).max() > 0.1
    assert ciderd_used == {"jax": [True], "torch": [True]}


BUILD_AND_LOAD = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from test_torch_native_ciderd import build_native_library
built = build_native_library(sys.argv[2], sys.argv[3])
ctypes.CDLL(sys.argv[3]).ciderd_create
print(int(built))
"""


def test_concurrent_builds_compile_once_and_always_load(tmp_path):
    """Six processes started together on a fresh build directory: one
    compiles, and every one loads a whole library."""
    src = str(tmp_path / "ciderd.cpp")
    shutil.copy(jnative._SRC, src)
    lib = str(tmp_path / "build" / "libciderd.so")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_LOAD, here,
                               src, lib], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert sorted(int(o) for o, _ in outs) == [0] * 5 + [1]
    # no temporary file is left behind
    assert sorted(os.listdir(tmp_path / "build")) == [".lock",
                                                      "libciderd.so"]
