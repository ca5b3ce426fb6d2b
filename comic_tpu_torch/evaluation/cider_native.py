"""ctypes bindings for the native C++ CIDEr-D scorer (the port's own copy of
comic_tpu.evaluation.cider_native, over ``comic_tpu_torch/csrc/ciderd.cpp``).

The source is compiled with g++ at first use into
``comic_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash of
the source and flags, written to a temporary file and renamed into place,
so concurrent processes never load a half-written library. Without a
toolchain ``make_ciderd`` returns the pure-Python ``cider.CiderD``, as
comic_tpu does: the scores are the same to double precision. Callers that
must know which one runs read ``CaptionScorer.ciderd_impl``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .ids import id_sort_key

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ciderd.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"ciderd-{h.hexdigest()[:16]}.so")


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = _library_path()
            if not os.path.exists(path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = f"{type(e).__name__}: {getattr(e, 'stderr', e)}"
            return None
        lib.ciderd_create.restype = ctypes.c_void_p
        lib.ciderd_create.argtypes = []
        lib.ciderd_destroy.restype = None
        lib.ciderd_destroy.argtypes = [ctypes.c_void_p]
        lib.ciderd_set_df.restype = None
        lib.ciderd_set_df.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_double]
        lib.ciderd_score.restype = None
        lib.ciderd_score.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def build_error() -> Optional[str]:
    """Why the native scorer could not be built or loaded (None when it
    was, or has not been tried)."""
    return _build_error


class NativeCiderD:
    """Drop-in for cider.CiderD backed by csrc/ciderd.cpp."""

    def __init__(self, df: Optional[dict] = None):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native CIDEr-D unavailable: {_build_error}")
        self._lib = lib
        self._handle = lib.ciderd_create()
        if isinstance(df, dict) and "document_frequency" in df:
            self._load_df(df)

    def _load_df(self, cache: dict) -> None:
        dfd = cache["document_frequency"]
        # ngram words joined with \x1f (the native hashing frame)
        blob = "\n".join("\x1f".join(g) for g in dfd.keys()).encode("utf-8")
        vals = np.fromiter(dfd.values(), dtype=np.float64, count=len(dfd))
        # the on-disk ref_len is the raw corpus size; the log is applied
        # here (ciderD_scorer.py:82)
        self._lib.ciderd_set_df(
            self._handle, blob,
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(dfd), math.log(float(cache["ref_len"])))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.ciderd_destroy(handle)

    def compute_score(self, gts: Dict, res: Dict
                      ) -> Tuple[float, np.ndarray]:
        keys = sorted(gts, key=id_sort_key)
        hypos = [res[k][0] for k in keys]
        # group ids by identical reference lists (the SCST joint gts dict
        # repeats each image's refs across its hypotheses)
        seen: Dict[Tuple[str, ...], int] = {}
        gids = np.asarray([seen.setdefault(tuple(gts[k]), i)
                           for i, k in enumerate(keys)], dtype=np.int64)
        hypos_blob = "\n".join(hypos).encode("utf-8")
        refs_blob = "\x1e".join(
            "\n".join(gts[k]) for k in keys).encode("utf-8")
        out = np.zeros(len(keys), np.float64)
        self._lib.ciderd_score(
            self._handle, hypos_blob, refs_blob,
            gids.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(keys),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return float(out.mean()) if len(out) else 0.0, out

    def method(self) -> str:
        return "CIDEr-D"


def make_ciderd(df: Optional[dict] = None):
    """The native CiderD when it builds, else the pure-Python one."""
    if native_available():
        return NativeCiderD(df)
    from .cider import CiderD

    return CiderD(df)
