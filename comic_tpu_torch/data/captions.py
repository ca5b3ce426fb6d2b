"""Caption dataset file IO; counterpart of comic_tpu/data/captions.py.

The on-disk contract with the reference's offline prepro stage:
  - caption files ``{pattern}_{split}.txt``, one line per (image, caption):
    ``filepath,<GO> w0 w1 ... wN <EOS>`` (reference prepro_base.py:250-253,
    read at manager_image_caption.py:127-131);
  - vocab JSONs ``{pattern}_wtoi.json`` / ``{pattern}_itow.json``;
  - inference file lists ``filenames_{valid,test}.txt`` or a raw directory
    of images (manager_image_caption.py:64-80).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

from ..tokenization import Vocabulary

pjoin = os.path.join

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def read_caption_file(path: str) -> List[Tuple[str, List[str]]]:
    """-> list of (relative filepath, token list incl. <GO>/<EOS>)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            filepath, caption = line.split(",", 1)
            records.append((filepath, caption.split(" ")))
    return records


def caption_file_path(dataset_dir: str, pattern: str, split: str) -> str:
    if "{}" not in pattern:
        raise ValueError("`dataset_file_pattern` must have `{}`.")
    return pjoin(dataset_dir, "captions", pattern.format(split) + ".txt")


def load_vocab(dataset_dir: str, pattern: str) -> Vocabulary:
    base = pjoin(dataset_dir, "captions")
    return Vocabulary.load(pjoin(base, pattern.format("wtoi") + ".json"),
                           pjoin(base, pattern.format("itow") + ".json"))


def group_by_image(records: Sequence[Tuple[str, List[str]]],
                   max_refs: int = 5) -> List[Tuple[str, List[str]]]:
    """Caption records grouped per image: (filepath, reference strings
    without <GO>/<EOS>, at most ``max_refs``), in first-seen order
    (reference manager_image_caption.py:384-396,464-469)."""
    grouped: Dict[str, List[str]] = {}
    for fp, tokens in records:
        text = " ".join(tokens).replace("<GO> ", "").replace(" <EOS>", "")
        grouped.setdefault(fp, []).append(text)
    return [(fp, refs[:max_refs]) for fp, refs in grouped.items()]


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


def coco_image_id(filepath: str) -> int:
    """MS-COCO image id from a filename like COCO_val2014_000000123456.jpg
    (reference regex P_COCO, src/infer_fn.py:33)."""
    stem = os.path.splitext(os.path.basename(filepath))[0]
    return int(stem.split("_")[-1])
