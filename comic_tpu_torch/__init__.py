"""comic_tpu_torch: the PyTorch/CUDA port of comic_tpu for one NVIDIA H100.

It mirrors comic_tpu's module layout and parameter tree (TF-slim names),
reads the same configs and compact checkpoints, and gives the same
captions from the same weights. Plain tensor code is PyTorch; each Pallas
kernel of comic_tpu is a CUDA C++ kernel for sm_90a under ``csrc/``, built
at first use (``ops/_cuda.py``).

This package imports neither JAX nor comic_tpu: it keeps its own copies of
the pure-Python modules it needs. Entry points take ``device=None``, which
means the card; they raise when CUDA is missing unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card. Raises when a CUDA device is asked for and
    this process has none: the port never falls back to the CPU on its
    own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "comic_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU.")
    return device
