"""Inference input pipeline; counterpart of InferencePipeline,
_ImageLoaderPool and _prefetch in comic_tpu/data/pipeline.py.

A thread pool decodes and resizes images on the host into fixed 256x256
uint8 batches, and a bounded queue prefetches batches ahead of the device.
The packed-HDF5 source and the training pipelines wait for later slices.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..configuration import Config
from . import captions as cap_io
from .preprocessing import RESIZE_SIZE, load_and_resize_host


def _check_square_resize(config: Config) -> None:
    """Only the inception-style (square resize) host path is ported."""
    from ..models.encoders import get_encoder

    if get_encoder(config.cnn_name).preprocessing == "vgg":
        raise NotImplementedError(
            "The aspect-preserving (vgg/resnet) host resize is not yet "
            "ported to comic_tpu_torch.")


class _ImageLoaderPool:
    """Thread pool turning filepaths into fixed-shape uint8 images."""

    def __init__(self, num_workers: int = 8, tf1_exact: bool = False):
        self.num_workers = num_workers
        self.tf1_exact = tf1_exact
        self._pool: Optional[ThreadPoolExecutor] = None  # lazy, persistent
        self._closed = False

    def load(self, paths: Sequence[str]) -> np.ndarray:
        if self._closed:
            raise ValueError("load() on a closed _ImageLoaderPool")
        out = np.empty((len(paths), RESIZE_SIZE, RESIZE_SIZE, 3), np.uint8)

        def load_one(i):
            out[i] = load_and_resize_host(paths[i], tf1_exact=self.tf1_exact)

        if len(paths) == 1:
            load_one(0)
            return out
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        # result() re-raises a worker's exception instead of leaving its
        # slice of the batch uninitialized
        for f in [self._pool.submit(load_one, i) for i in range(len(paths))]:
            f.result()
        return out

    def close(self):
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _prefetch(gen: Iterator, depth: int,
              registry: Optional[list] = None) -> Iterator:
    """Run ``gen`` in a background thread with a bounded queue.

    A worker exception is re-raised in the consumer. The worker's puts poll
    a stop event; the consumer sets it and joins the thread when it ends,
    and ``registry`` receives (stop_event, thread) so an owner's close()
    can stop and join the worker before closing the loader it reads.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    _ERR = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # re-raised on the consumer side
            put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    if registry is not None:
        registry.append((stop, t))

    def consume():
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)

    return consume()


class InferencePipeline:
    """Inference batches: (images_u8, filepaths). The file count must tile
    the batch size (reference manager_image_caption.py:64-80)."""

    def __init__(self, config: Config, files: Optional[List[str]] = None,
                 num_workers: int = 8):
        self.config = config
        if config.get("packed_dataset"):
            raise NotImplementedError(
                "The packed-HDF5 image source is not yet ported to "
                "comic_tpu_torch.")
        _check_square_resize(config)
        if files is None:
            files = cap_io.infer_file_list(
                config.dataset_dir, config.infer_set,
                config.dataset_file_pattern)
        self.files = files
        self.batch_size = config.batch_size_infer
        if len(files) % self.batch_size != 0:
            raise ValueError(
                f"Infer batch size {self.batch_size} must divide file "
                f"count {len(files)}")
        self.loader = _ImageLoaderPool(
            num_workers, tf1_exact=bool(config.get("host_resize_tf1")))
        self._prefetchers: list = []

    def __iter__(self):
        def gen():
            for lo in range(0, len(self.files), self.batch_size):
                chunk = self.files[lo: lo + self.batch_size]
                paths = [cap_io.pjoin(self.config.dataset_dir, f)
                         for f in chunk]
                yield self.loader.load(paths), chunk

        return _prefetch(gen(), 4, registry=self._prefetchers)

    def __len__(self):
        return len(self.files) // self.batch_size

    def close(self):
        """Stop and join the prefetch workers, then release the loader."""
        for stop, _ in self._prefetchers:
            stop.set()
        for _, t in self._prefetchers:
            t.join(timeout=10.0)
        self._prefetchers.clear()
        self.loader.close()
