"""Build, load and argument checks for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the sources in this package only, into
``comic_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is reused. ``build()`` compiles several sources in parallel, one ``nvcc``
each. Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("grouped_add_ln_attention", "fused_add_ln_attention")
_HEADERS = ("add_ln_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds comic_tpu_torch's kernels.")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, all at once.

    Returns {name: compiler log} (ptxas' register and spill report) for the
    ones compiled here; raises with the log of any that failed.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<name>.cu``, built if needed;
    it returns a CUDA error code."""
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            path = _library_path(name)
            if not os.path.exists(path):
                build([name])
            fn = getattr(ctypes.CDLL(path), name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
    return fn


# --- argument checks shared by the wrappers -----------------------------------

def check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` (None = any
    size on that axis) and one of ``dtypes`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_width(keys: torch.Tensor, head_dim: int) -> int:
    """Channels per 16-byte key load (8 bf16 / 4 f32) when that width
    divides a head and the keys are 16-byte aligned, else 1."""
    vec = 16 // keys.element_size()
    if head_dim % vec == 0 and keys.data_ptr() % 16 == 0:
        return vec
    return 1


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
