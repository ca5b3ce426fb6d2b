"""Scalar and image logging; counterpart of comic_tpu/utils/summaries.py.

Every record is one line of ``events.jsonl`` in the log directory, as
comic_tpu writes it: {"step": int, "time": float, <name>: float, ...}.
Where TensorBoard is installed, the scalars also go to a TensorBoard
writer (torch.utils.tensorboard); where it is not, the writer says so once
and writes the JSONL only. Images are PNG files beside events.jsonl,
encoded here (zlib), so no image library is needed.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
import zlib
from typing import Dict

import numpy as np


def png_bytes(image_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG file bytes (8-bit truecolour, no
    filtering)."""
    img = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


class SummaryWriter:
    """``enabled`` False writes nothing: the writer of a data-parallel
    rank other than 0, so one set of files reaches the log directory."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 enabled: bool = True):
        self.enabled = enabled
        self._dir = log_dir
        self._jsonl = self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter as TB
            except ImportError:
                print("NOTE: TensorBoard is not installed; metrics go to "
                      "events.jsonl only.", file=sys.stderr)
            else:
                self._tb = TB(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def image(self, step: int, name: str, array_u8) -> None:
        """Log an HWC uint8 RGB image as ``<name>___<step>.png`` (the
        reference's add_image_summaries, train_fn.py:75)."""
        if not self.enabled:
            return
        arr = np.asarray(array_u8)
        safe = name.replace("/", "_")
        with open(os.path.join(self._dir, f"{safe}___{int(step)}.png"),
                  "wb") as f:
            f.write(png_bytes(arr))
        if self._tb is not None:
            self._tb.add_image(name, arr, int(step), dataformats="HWC")
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
