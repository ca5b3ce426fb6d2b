"""Synthetic dataset fixture; counterpart of comic_tpu/data/synthetic.py.

A tiny fake dataset in the on-disk format the framework (and the
reference) consume: caption txts, wtoi/itow JSONs, filename lists,
COCO-format annotation JSONs and JPEG images. Given the same arguments,
``make_synthetic_dataset`` writes comic_tpu's files byte for byte (the
JPEGs when both run under the same PIL): the draws come from the same
seeded streams, ``random.Random(seed)`` for the captions and
``np.random.default_rng(seed)`` for the pixels.

Drawing is apart from writing: ``draw_synthetic_dataset`` returns the
records and the image arrays in memory, ``write_caption_artifacts``
writes every file but the images, so a machine without PIL can still
build the fixture and feed the arrays to the pipelines itself.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..tokenization import EOS, GO, Vocabulary, build_vocab
from ..utils.optional import require

pjoin = os.path.join

_WORDS = [
    "a", "man", "woman", "dog", "cat", "riding", "sitting", "on", "the",
    "beach", "street", "table", "bike", "red", "blue", "holding", "standing",
    "near", "group", "of", "people", "playing", "with", "in", "park",
]

Record = Tuple[str, List[str]]  # (image path under the dataset, words)


@dataclass
class SyntheticDataset:
    records: Dict[str, List[Record]]  # split -> records, in file order
    images: Dict[str, np.ndarray]  # image path -> (size, size, 3) uint8
    vocab: Vocabulary
    style: str


def draw_synthetic_dataset(
    num_train: int = 32,
    num_valid: int = 8,
    num_test: int = 8,
    image_size: int = 256,
    seed: int = 0,
    captions_per_image: int = 2,
    style: str = "coco",
    test_mirrors_train: bool = False,
    distinct_images: bool = False,
) -> SyntheticDataset:
    """The fixture in memory; the arguments are make_synthetic_dataset's."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)

    def make_caption() -> List[str]:
        n = rng.randint(4, 12)
        return [rng.choice(_WORDS) for _ in range(n)]

    splits = {"train": num_train, "valid": num_valid, "test": num_test}
    all_train_tokens = []
    records: Dict[str, List[Record]] = {}
    images: Dict[str, np.ndarray] = {}
    img_idx = 0
    for split, count in splits.items():
        rows = []
        for _ in range(count):
            if style == "insta":
                fname = f"images/user{img_idx}_@_post.jpg"
            else:
                fname = f"images/COCO_synth_{img_idx:012d}.jpg"
            if distinct_images:
                colour = np_rng.integers(0, 256, (1, 1, 3))
                noise = np_rng.integers(-20, 21,
                                        (image_size, image_size, 3))
                images[fname] = np.clip(colour + noise, 0, 255).astype(
                    np.uint8)
            else:
                images[fname] = np_rng.integers(
                    0, 256, (image_size, image_size, 3), dtype=np.uint8)
            n_caps = captions_per_image if split == "train" else 1
            for _ in range(n_caps):
                toks = make_caption()
                rows.append((fname, toks))
                if split == "train":
                    all_train_tokens.append(toks)
            img_idx += 1
        records[split] = rows
    if test_mirrors_train:
        records["test"] = list(records["train"])
    vocab = build_vocab(all_train_tokens, word_count_thres=1,
                        caption_len_thres=20)
    return SyntheticDataset(records, images, vocab, style)


def write_caption_artifacts(root: str, data: SyntheticDataset,
                            pattern: str = "synth_{}") -> None:
    """Every file of the fixture but the images: the caption txts, the
    wtoi/itow JSONs, the valid/test filename lists and annotation JSONs."""
    os.makedirs(pjoin(root, "captions"), exist_ok=True)
    for split, rows in data.records.items():
        with open(pjoin(root, "captions", pattern.format(split) + ".txt"),
                  "w") as f:
            for fname, toks in rows:
                f.write(f"{fname},{GO} {' '.join(toks)} {EOS}\n")

    data.vocab.save(pjoin(root, "captions", pattern.format("wtoi") + ".json"),
                    pjoin(root, "captions", pattern.format("itow") + ".json"))

    for split in ("valid", "test"):
        files = sorted({fname for fname, _ in data.records[split]})
        with open(pjoin(root, "captions", f"filenames_{split}.txt"), "w") as f:
            f.write("\n".join(files) + "\n")
        # COCO-format annotation JSON for metric scoring
        anns = []
        for i, (fname, toks) in enumerate(data.records[split]):
            stem = fname.split("/")[-1].rsplit(".", 1)[0]
            image_id = (stem if data.style == "insta"
                        else int(stem.split("_")[-1]))
            anns.append({"image_id": image_id, "id": i,
                         "caption": " ".join(toks)})
        with open(pjoin(root, "captions", f"annotations_{split}.json"),
                  "w") as f:
            json.dump({"annotations": anns}, f)


def make_synthetic_dataset(
    root: str,
    num_train: int = 32,
    num_valid: int = 8,
    num_test: int = 8,
    pattern: str = "synth_{}",
    image_size: int = 256,
    seed: int = 0,
    captions_per_image: int = 2,
    style: str = "coco",
    test_mirrors_train: bool = False,
    distinct_images: bool = False,
) -> Tuple[str, Vocabulary]:
    """Create a dataset under ``root``; returns (dataset_dir, vocab).

    style='insta' names images like InstaPIC posts (no trailing numeric
    id), so image ids stay strings end to end (insta_prepro.py).

    test_mirrors_train=True makes the test split reuse the train images
    and captions, so inference on ``test`` measures memorization of the
    training set (the overfit gate's fixture).

    distinct_images=True draws each image as one solid colour (plus mild
    pixel noise) instead of uniform noise: a random train-time crop and
    flip of a noise image is an unrelatable patch, while a solid colour
    survives any crop or flip, so image-to-caption memorization is
    learnable. The JPEGs need PIL."""
    data = draw_synthetic_dataset(
        num_train=num_train, num_valid=num_valid, num_test=num_test,
        image_size=image_size, seed=seed,
        captions_per_image=captions_per_image, style=style,
        test_mirrors_train=test_mirrors_train,
        distinct_images=distinct_images)
    os.makedirs(pjoin(root, "images"), exist_ok=True)
    pil_image = require("PIL.Image", "Writing the fixture's JPEGs")
    for fname, arr in data.images.items():
        pil_image.fromarray(arr).save(pjoin(root, fname), quality=60)
    write_caption_artifacts(root, data, pattern)
    return root, data.vocab
