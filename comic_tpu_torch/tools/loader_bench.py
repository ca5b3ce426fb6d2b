"""Host input-loader throughput: can the host keep the card fed? The
port's counterpart of tools/loader_bench.py (host only, no card).

    python -m comic_tpu_torch.tools.loader_bench TARGET_CAPTIONS_PER_S
        [--images 96] [--min_s 2.0]

On photo-like synthetic JPEGs at COCO's size (640x480, quality 90) it
measures the file loader (``data.pipeline._ImageLoaderPool``: decode and
resize on a thread pool, cv2 else PIL) in images/s against its worker
count, in the square and the aspect_eval modes, and the packed HDF5 source
(``data.pipeline.PackedImageSource``: images decoded at prepro time, a
read is a copy), then the cores the file loader needs to sustain the
target. Where the host lacks PIL (which writes the JPEGs) or h5py, the
fields it would measure hold the name of what is missing. Prints one JSON
line; ``bench.bench_host_loader`` reads it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

WORKERS = (1, 2, 4, 8)


def make_jpegs(root: str, n: int = 96, h: int = 480, w: int = 640):
    """Photo-like JPEGs: smoothed noise over a gradient, COCO's size."""
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = (
            128
            + 60 * np.sin(xx / (20 + i % 7) + i)
            + 40 * np.cos(yy / (25 + i % 5))
        )[..., None] + rng.normal(0, 18, (h, w, 3))
        # a 2x2 box blur brings the spectrum near a photo's
        arr = np.clip(base, 0, 255).astype(np.uint8)
        arr = ((arr[::2, ::2].astype(np.uint16)
                + arr[1::2, ::2] + arr[::2, 1::2] + arr[1::2, 1::2]) // 4
               ).astype(np.uint8).repeat(2, 0).repeat(2, 1)
        p = os.path.join(root, f"img_{i:04d}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
    return paths


def rate(load, paths, batch: int = 32, min_s: float = 2.0) -> float:
    """images/s over repeated batch loads (the first call warms the
    pool)."""
    batch = min(batch, len(paths))
    load(paths[:batch])
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < min_s:
        lo = (n * batch) % (len(paths) - batch + 1)
        load(paths[lo:lo + batch])
        n += 1
    return n * batch / (time.perf_counter() - t0)


def write_pack(path: str, paths) -> None:
    """A packed HDF5 dataset of ``paths`` as prepro writes one: the
    caption-line datasets and the images square-resized to the loader's
    shape."""
    import h5py

    from comic_tpu_torch.data.preprocessing import (RESIZE_SIZE,
                                                    _resize_host,
                                                    decode_image_host)

    text = h5py.special_dtype(vlen=str)
    with h5py.File(path, "w") as f:
        for split in ("train", "valid"):
            f.create_dataset(split, (0,), dtype=text)
        lines = [f"{i},{os.path.basename(p)},x" for i, p in enumerate(paths)]
        f.create_dataset("test", (len(lines),), dtype=text)[:] = lines
        imgs = f.create_dataset(
            "images", (len(paths), RESIZE_SIZE, RESIZE_SIZE, 3),
            chunks=(4, RESIZE_SIZE, RESIZE_SIZE, 3), dtype="uint8")
        for i, p in enumerate(paths):
            imgs[i] = _resize_host(decode_image_host(p), RESIZE_SIZE,
                                   RESIZE_SIZE)


def measure(target: float, n_images: int = 96, min_s: float = 2.0) -> dict:
    from comic_tpu_torch.data.pipeline import (PackedImageSource,
                                               _ImageLoaderPool)

    ncores = os.cpu_count() or 1
    out = {"host_cores": ncores, "target_images_per_s": target}
    file_keys = ([f"file_loader_square_w{w}" for w in WORKERS]
                 + ["file_loader_aspect_w8",
                    "file_loader_images_per_s_per_core",
                    "cores_to_sustain_target", "jpeg_kb_mean"])
    if importlib.util.find_spec("PIL") is None:
        out.update(dict.fromkeys(file_keys + ["packed_h5_images_per_s"],
                                 "PIL not installed"))
        return out
    with tempfile.TemporaryDirectory() as root:
        paths = make_jpegs(root, n_images)
        kb = np.mean([os.path.getsize(p) for p in paths]) / 1e3
        out["jpeg_kb_mean"] = round(kb, 1)
        print(f"{len(paths)} synthetic JPEGs, mean {kb:.0f} KB "
              f"({ncores}-core host)", file=sys.stderr)
        for workers in WORKERS:
            pool = _ImageLoaderPool(workers, mode="square")
            try:
                r = rate(pool.load, paths, min_s=min_s)
            finally:
                pool.close()
            out[f"file_loader_square_w{workers}"] = round(r, 1)
            print(f"square  w={workers:<2} {r:8.1f} images/s",
                  file=sys.stderr, flush=True)
        pool = _ImageLoaderPool(8, mode="aspect_eval")
        try:
            r = rate(pool.load, paths, min_s=min_s)
        finally:
            pool.close()
        out["file_loader_aspect_w8"] = round(r, 1)
        print(f"aspect  w=8  {r:8.1f} images/s", file=sys.stderr)
        # one worker's rate is the per-core rate
        per_core = out["file_loader_square_w1"]
        out["file_loader_images_per_s_per_core"] = per_core
        out["cores_to_sustain_target"] = round(target / per_core, 1)

        if importlib.util.find_spec("h5py") is None:
            out["packed_h5_images_per_s"] = "h5py not installed"
        else:
            h5 = os.path.join(root, "packed.h5")
            write_pack(h5, paths)
            src = PackedImageSource(h5)
            try:
                r = rate(src.load, [os.path.basename(p) for p in paths],
                         min_s=min_s)
            finally:
                src.close()
            out["packed_h5_images_per_s"] = round(r, 1)
            print(f"packed  h5  {r:8.1f} images/s", file=sys.stderr)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("target", type=float,
                   help="captions/s the loader should sustain")
    p.add_argument("--images", type=int, default=96,
                   help="synthetic JPEGs to write")
    p.add_argument("--min_s", type=float, default=2.0,
                   help="seconds each rate is measured over")
    args = p.parse_args(argv)
    out = measure(args.target, args.images, args.min_s)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
