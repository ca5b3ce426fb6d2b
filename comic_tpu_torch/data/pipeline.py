"""Input pipelines; counterpart of TrainPipeline, ScstPipeline,
InferencePipeline, _ImageLoaderPool and _prefetch in
comic_tpu/data/pipeline.py (reference manager_image_caption.py:27-509).

A thread pool decodes and resizes images on the host into fixed 256x256
uint8 batches, and a bounded queue prefetches batches ahead of the device.
Training batches are bucketed by caption length and padded UP to their
bucket's bound (comic_tpu's static shapes), drawn in comic_tpu's order from
``random.Random(seed)``, so both packages see the same batches.
Inference can also read pre-decoded images from a packed HDF5 dataset
(``PackedImageSource``). Multi-process sharding waits for a later slice.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..configuration import Config
from ..parallel.mesh import host_count, in_job, job_ranks, process_index
from ..tokenization import (RadixCodec, Vocabulary, build_char_vocab,
                            encode_caption_tokens)
from . import captions as cap_io
from .preprocessing import RESIZE_SIZE, load_and_resize_host

PAD_ID = -1


def bucket_boundaries(config: Config, vocab: Vocabulary,
                      caption_len_thres: int = 20,
                      max_encoded_len: Optional[int] = None) -> List[int]:
    """Sequence-length bucket upper bounds plus an overflow bucket.

    The first three bounds are the reference's (COCO word [11,13,15],
    Insta [7,10,13], char [45,55,70]/[29,42,61], radix = word bounds x
    digit width; manager_image_caption.py:83-86,246-247,293-296). Each
    batch pads up to its bucket's bound; the overflow bucket is capped at
    the longest possible caption, raised to ``max_encoded_len`` (the
    longest encoded caption in the data) so that no caption is truncated.
    """
    pattern = config.dataset_file_pattern or ""
    is_insta = "insta" in pattern
    if config.token_type == "char":
        bounds = [29, 42, 61] if is_insta else [45, 55, 70]
        cap = caption_len_thres * 6 + 2
    elif config.token_type == "radix":
        width = RadixCodec(len(vocab), config.radix_base).word_len
        words = [7, 10, 13] if is_insta else [11, 13, 15]
        bounds = [b * width for b in words]
        cap = caption_len_thres * width + 2
    else:
        bounds = [7, 10, 13] if is_insta else [11, 13, 15]
        cap = caption_len_thres + 2
    if max_encoded_len is not None:
        cap = max(cap, int(max_encoded_len))
    return bounds + [cap]


def pick_bucket(length: int, bounds: Sequence[int]) -> int:
    for i, b in enumerate(bounds):
        if length <= b:
            return i
    return len(bounds) - 1


def pad_rows(rows: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(rows), width), PAD_ID, np.int32)
    for i, r in enumerate(rows):
        out[i, : min(len(r), width)] = r[:width]
    return out


def host_resize_mode(config: Config, is_training: bool) -> str:
    """Host resize policy per encoder family: 'square' for inception-style
    nets; for vgg/resnet the aspect-preserving resize, with the train-time
    scale jitter in training (reference preprocessing_factory.py:31-84,
    vgg_preprocessing.py:286-365). An unknown cnn_name raises here."""
    from ..models.encoders import get_encoder

    if get_encoder(config.cnn_name).preprocessing != "vgg":
        return "square"
    return "aspect_train" if is_training else "aspect_eval"


class _ImageLoaderPool:
    """Thread pool turning filepaths into fixed-shape uint8 images in host
    resize ``mode``. In 'aspect_train' each image of a batch draws its
    scale jitter and crop from its own numpy Generator, seeded from one
    Generator of ``seed`` in image order (comic_tpu's streams: the same
    seed gives the same images)."""

    def __init__(self, num_workers: int = 8, mode: str = "square",
                 tf1_exact: bool = False, seed: Optional[int] = None):
        self.num_workers = num_workers
        self.mode = mode
        self.tf1_exact = tf1_exact
        self._rng = np.random.default_rng(seed)
        self._pool: Optional[ThreadPoolExecutor] = None  # lazy, persistent
        self._closed = False

    def load(self, paths: Sequence[str]) -> np.ndarray:
        if self._closed:
            raise ValueError("load() on a closed _ImageLoaderPool")
        out = np.empty((len(paths), RESIZE_SIZE, RESIZE_SIZE, 3), np.uint8)
        seeds = (self._rng.integers(0, 2**63, len(paths))
                 if self.mode == "aspect_train" else None)

        def load_one(i):
            rng = (np.random.default_rng(int(seeds[i]))
                   if seeds is not None else None)
            out[i] = load_and_resize_host(paths[i], mode=self.mode,
                                          tf1_exact=self.tf1_exact, rng=rng)

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


def _path_suffix_match(query: str, packed: str) -> bool:
    """True when one path's components are a trailing suffix of the other's:
    'x.jpg' or '/data/coco/train2014/x.jpg' against a packed
    'train2014/x.jpg', but not a directory mismatch such as
    'val_subset/x.jpg'."""
    q = [c for c in query.replace(os.sep, "/").split("/") if c]
    f = [c for c in packed.split("/") if c]
    return q[-len(f):] == f or f[-len(q):] == q


class PackedImageSource:
    """Fixed-shape uint8 images served from a packed HDF5 dataset
    (comic_tpu's PackedImageSource; the pack is written by comic_tpu's
    prepro ``serialise_everything``, reference prepro_base.py:288-360).

    The pack holds every image already decoded and square-resized to the
    loader's shape, so a batch is a copy out of the file instead of a JPEG
    decode and resize per image. Same ``load(paths)`` contract as
    ``_ImageLoaderPool``; rows are looked up by the relative filepath of
    the pack's caption lines, falling back to the basename where the
    directories agree (infer file lists may carry bare filenames).
    ``h5py`` is imported here, on first use.
    """

    def __init__(self, h5_path: str, mode: str = "square",
                 tf1_exact: bool = False):
        import h5py

        if mode != "square":
            raise ValueError(
                "packed_dataset images are square-resized at pack time; "
                f"this config's encoder needs host resize mode '{mode}' "
                "(vgg-family aspect preprocessing) — use the file loader.")
        if tf1_exact:
            raise ValueError(
                "packed_dataset images were packed with the default host "
                "bilinear; host_resize_tf1 would silently not apply — "
                "unset it or use the file loader.")
        self._f = h5py.File(h5_path, "r")
        try:
            images = self._f["images"]
            if images.shape[1:] != (RESIZE_SIZE, RESIZE_SIZE, 3):
                raise ValueError(
                    f"packed images are {images.shape[1:]}, loader "
                    f"contract is ({RESIZE_SIZE}, {RESIZE_SIZE}, 3) — "
                    f"repack with image_size=({RESIZE_SIZE}, "
                    f"{RESIZE_SIZE}).")
            # filepath -> row from the '<row>,<filepath>,<caption>' lines
            # (the first line of a filepath wins); `_by_base` keeps (row,
            # filepath) candidates for the basename fallback. The index is
            # built inside the try, so a malformed pack closes its handle.
            self._index: dict = {}
            self._by_base: dict = {}
            for split in ("train", "valid", "test"):
                for line in self._f[split][:]:
                    line = (line.decode() if isinstance(line, bytes)
                            else line)
                    row_s, fpath = line.split(",", 2)[:2]
                    if fpath in self._index:
                        continue
                    self._index[fpath] = int(row_s)
                    self._by_base.setdefault(
                        os.path.basename(fpath), []).append(
                            (int(row_s), fpath))
        except Exception:
            self._f.close()
            raise
        self._images = images

    def load(self, paths: Sequence[str]) -> np.ndarray:
        out = np.empty((len(paths), RESIZE_SIZE, RESIZE_SIZE, 3), np.uint8)
        for i, p in enumerate(paths):
            row = self._index.get(p)
            if row is None:
                # the basename fallback only where the directories agree: a
                # unique basename in another directory must refuse, not
                # serve that image
                cands = self._by_base.get(os.path.basename(p), ())
                hits = [(r, f) for r, f in cands if _path_suffix_match(p, f)]
                if len(hits) > 1:
                    raise KeyError(
                        f"{p!r} matches multiple packed images by basename "
                        "— pass the relative filepath recorded in the "
                        "pack's caption lines instead.")
                if len(hits) == 1:
                    row = hits[0][0]
                elif cands:
                    raise KeyError(
                        f"{p!r} is not in the packed dataset; entries "
                        "sharing its basename exist but in different "
                        f"directories ({[f for _, f in cands]!r}) — "
                        "refusing the basename fallback.")
            if row is None:
                raise KeyError(f"{p!r} is not in the packed dataset")
            self._images.read_direct(out, np.s_[row], np.s_[i])
        return out

    def close(self):
        self._f.close()


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


class TrainPipeline:
    """Training/eval batches of (images_u8, caption_ids); one instance per
    split. Mutates the config with the derived ``split_sizes`` and (train)
    ``max_step`` as comic_tpu and the reference do
    (manager_image_caption.py:55,132,141).

    ``records`` overrides the split's caption file; ``loader`` (anything
    with ``load(paths) -> (N, 256, 256, 3) uint8``) overrides the image
    files, e.g. with in-memory images.

    In a torch.distributed job a training split is split by process (as
    comic_tpu's ``shard_by_process``): the records, the shuffle and the
    bucket bounds stay global, the same on every rank. Each step takes a
    GLOBAL batch of batch_size records a host (comic_tpu's batch_size *
    jax.process_count()), whose padded width comes from the whole global
    batch, and splits it into equal blocks over the ranks that take part
    (parallel.mesh.job_ranks, with the config's num_data_shards): rank r
    loads only its contiguous block r, the layout mesh.global_batch
    expects, and an idle rank an empty block. ``max_step`` and
    ``steps_per_epoch`` count global batches, the same on every rank and
    the same as comic_tpu's for the same job.
    """

    def __init__(self, config: Config, vocab: Vocabulary, split: str,
                 records: Optional[List[Tuple[str, List[str]]]] = None,
                 num_workers: int = 8, seed: Optional[int] = None,
                 loader=None):
        self.config = config
        self.split = split
        self.is_training = "train" in split
        if config.token_type == "char":
            vocab = build_char_vocab()
            config.wtoi, config.itow = vocab.wtoi, dict(vocab.itow)
            config.vocab_size = len(vocab.itow)
        self.vocab = vocab
        if records is None:
            records = cap_io.read_caption_file(cap_io.caption_file_path(
                config.dataset_dir, config.dataset_file_pattern, split))
        self.records = records
        self._encoded = [encode_caption_tokens(toks, config.token_type,
                                               vocab, config.radix_base)
                         for _, toks in records]
        self.bounds = bucket_boundaries(
            config, vocab,
            max_encoded_len=max((len(r) for r in self._encoded), default=0))
        self.batch_size = (config.batch_size_train if self.is_training
                           else config.batch_size_eval)
        # hosts of the job, ranks that take a block of a global batch, rank
        self._hosts, self._parts, self._pid = 1, 1, 0
        if self.is_training and in_job():
            self._hosts, self._pid = host_count(), process_index()
            self._parts, _ = job_ranks(
                self._group, limit=int(config.get("num_data_shards") or 0))
        if loader is None:
            loader = _ImageLoaderPool(
                num_workers, mode=host_resize_mode(config, self.is_training),
                tf1_exact=bool(config.get("host_resize_tf1")),
                seed=config.rand_seed)
        self.loader = loader
        self.rng = random.Random(
            seed if seed is not None else config.rand_seed)
        if config.split_sizes is None:
            config.split_sizes = {}
        config.split_sizes[split] = len(records)
        if self.is_training:
            config.max_step = int(len(records) / self._group
                                  * config.max_epoch)
        elif len(records) % self.batch_size != 0:
            # the eval split must tile exactly (reference manager:123,145)
            raise ValueError(
                f"Eval batch size {self.batch_size} must divide eval "
                f"split size {len(records)}")

    @property
    def _group(self) -> int:
        """Records a step takes: the global batch."""
        return self.batch_size * self._hosts

    @property
    def steps_per_epoch(self) -> int:
        return len(self.records) // self._group

    def _epoch_order(self) -> List[int]:
        order = list(range(len(self.records)))
        if self.is_training:
            self.rng.shuffle(order)
        return order

    def _batches_of_indices(self) -> Iterator[List[int]]:
        """Bucket-homogeneous index batches covering one epoch (global
        batches of a training split); an eval split then flushes the
        per-bucket leftovers as mixed batches, so every record is seen
        (padding is loss-masked)."""
        buckets: List[List[int]] = [[] for _ in self.bounds]
        for idx in self._epoch_order():
            b = pick_bucket(len(self._encoded[idx]), self.bounds)
            buckets[b].append(idx)
            if len(buckets[b]) == self._group:
                yield buckets[b]
                buckets[b] = []
        if not self.is_training:
            rest = [i for b in buckets for i in b]
            for lo in range(0, len(rest), self.batch_size):
                yield rest[lo: lo + self.batch_size]

    def _make_batch(self, idxs: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        rows = [self._encoded[i] for i in idxs]
        # the width of the whole global batch, before this rank's block
        width = self.bounds[max(pick_bucket(len(r), self.bounds)
                                for r in rows)]
        blk = len(idxs) // self._parts
        lo = min(self._pid, self._parts) * blk  # an idle rank: empty
        hi = lo + blk if self._pid < self._parts else lo
        idxs, rows = idxs[lo:hi], rows[lo:hi]
        paths = [cap_io.pjoin(self.config.dataset_dir, self.records[i][0])
                 for i in idxs]
        return self.loader.load(paths), pad_rows(rows, width)

    def epoch(self, prefetch_depth: int = 4
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass over the split: full coverage for an eval split; for a
        training split a one-epoch sample whose bucket state resets (the
        training loop uses ``iter(pipe)``)."""
        gen = (self._make_batch(idxs) for idxs in self._batches_of_indices())
        return _prefetch(gen, prefetch_depth)

    def __iter__(self):
        if not self.is_training:
            def eval_gen():
                while True:
                    yield from self.epoch()

            return eval_gen()

        # bucket state persists ACROSS epochs, like the reference's repeated
        # tf.data + bucket_by_sequence_length: a reset per epoch starves
        # when no bucket fills a batch within one epoch
        def gen():
            buckets: List[List[int]] = [[] for _ in self.bounds]
            while True:
                for idx in self._epoch_order():
                    b = pick_bucket(len(self._encoded[idx]), self.bounds)
                    buckets[b].append(idx)
                    if len(buckets[b]) == self._group:
                        yield self._make_batch(buckets[b])
                        buckets[b] = []

        return _prefetch(gen(), 4)

    def close(self):
        if hasattr(self.loader, "close"):
            self.loader.close()


class ScstPipeline:
    """SCST batches: (images_u8, list of per-image reference strings),
    comic_tpu's ScstPipeline. Records are grouped by image
    (``captions.group_by_image``), drawn in comic_tpu's order from
    ``random.Random(seed)``, not bucketed; each epoch drops its remainder
    (manager_image_caption.py:360-474). Sets the config's
    ``split_sizes['train']`` and ``max_step``.

    ``records`` ((path, reference strings) per image) overrides the train
    caption file; ``loader`` overrides the image files, as in
    TrainPipeline. In a torch.distributed job it is not split: every rank
    loads the same batch (its refs are scored rank by rank,
    training/scst.host_score_shard).
    """

    def __init__(self, config: Config, vocab: Vocabulary,
                 records: Optional[List[Tuple[str, List[str]]]] = None,
                 num_workers: int = 8, seed: Optional[int] = None,
                 loader=None):
        self.config = config
        self.vocab = vocab
        if records is None:
            records = cap_io.group_by_image(cap_io.read_caption_file(
                cap_io.caption_file_path(config.dataset_dir,
                                         config.dataset_file_pattern,
                                         "train")))
        self.records = records
        self.batch_size = config.batch_size_train
        if loader is None:
            loader = _ImageLoaderPool(
                num_workers, mode=host_resize_mode(config, True),
                tf1_exact=bool(config.get("host_resize_tf1")),
                seed=config.rand_seed)
        self.loader = loader
        self.rng = random.Random(
            seed if seed is not None else config.rand_seed)
        if config.split_sizes is None:
            config.split_sizes = {}
        config.split_sizes["train"] = len(records)
        config.max_step = int(
            len(records) / self.batch_size * config.max_epoch)

    def epoch(self, prefetch_depth: int = 4):
        order = list(range(len(self.records)))
        self.rng.shuffle(order)

        def gen():
            for lo in range(0, len(order) - self.batch_size + 1,
                            self.batch_size):
                idxs = order[lo: lo + self.batch_size]
                paths = [cap_io.pjoin(self.config.dataset_dir,
                                      self.records[i][0]) for i in idxs]
                refs = [self.records[i][1] for i in idxs]
                yield self.loader.load(paths), refs

        return _prefetch(gen(), prefetch_depth)

    def __iter__(self):
        while True:
            yield from self.epoch()

    def close(self):
        if hasattr(self.loader, "close"):
            self.loader.close()


class InferencePipeline:
    """Inference batches: (images_u8, filepaths). The file count must tile
    the batch size (reference manager_image_caption.py:64-80); that is
    checked before a loader is built. With ``packed_dataset`` set, images
    come from the pack (``PackedImageSource``), keyed on the files'
    relative paths."""

    def __init__(self, config: Config, files: Optional[List[str]] = None,
                 num_workers: int = 8):
        self.config = config
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
        packed = config.get("packed_dataset")
        tf1_exact = bool(config.get("host_resize_tf1"))
        if packed:
            self.loader = PackedImageSource(
                packed, mode=host_resize_mode(config, False),
                tf1_exact=tf1_exact)
        else:
            self.loader = _ImageLoaderPool(
                num_workers, mode=host_resize_mode(config, False),
                tf1_exact=tf1_exact)
        self._join_dataset_dir = not packed  # packed rows key on rel paths
        self._prefetchers: list = []

    def __iter__(self):
        def gen():
            for lo in range(0, len(self.files), self.batch_size):
                chunk = self.files[lo: lo + self.batch_size]
                paths = ([cap_io.pjoin(self.config.dataset_dir, f)
                          for f in chunk]
                         if self._join_dataset_dir else chunk)
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
