"""Inference file lists; counterpart of comic_tpu/data/captions.py
(reference manager_image_caption.py:64-80)."""

from __future__ import annotations

import os
from typing import List

pjoin = os.path.join

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def infer_file_list(dataset_dir: str, infer_set: str,
                    dataset_file_pattern: str) -> List[str]:
    """Image paths (relative to ``dataset_dir``) for inference.

    COCO-style: ``filenames_{valid,test}.txt`` beside the caption files;
    ``coco_test``/``coco_valid`` enumerate the raw server dirs.
    """
    if infer_set in ("test", "valid"):
        list_file = pjoin(dataset_dir, "captions",
                          f"filenames_{infer_set}.txt")
        with open(list_file) as f:
            return [line.strip() for line in f if line.strip()]
    if infer_set in ("coco_test", "coco_valid"):
        sub = "test2014" if infer_set == "coco_test" else "val2014"
        d = pjoin(dataset_dir, sub)
        return sorted(
            pjoin(sub, fn) for fn in os.listdir(d)
            if fn.lower().endswith(IMAGE_EXTENSIONS))
    raise ValueError(f"Unknown infer_set: {infer_set}")
