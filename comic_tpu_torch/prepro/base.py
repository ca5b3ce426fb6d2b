"""Dataset preparation core: a tokenised dataset -> the framework's
artifacts; counterpart of comic_tpu/prepro/base.py (reference
datasets/preprocessing/prepro_base.py).

It takes a Karpathy-style tokenised dataset and writes the stable on-disk
contract: per-split caption txts (``filepath,<GO> tokens <EOS>``,
truncated to the caption length threshold, restval folded into train,
prepro_base.py:226-254), wtoi/itow vocabulary JSONs (build_vocab's id
layout, :149-223), ``filenames_{valid,test}.txt`` lists, COCO-format
annotation JSONs, and the packed HDF5 (h5py, imported only by the two
functions that read or write it).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..tokenization import EOS, GO, Vocabulary, build_vocab
from ..utils.optional import require

pjoin = os.path.join

# reference-exact (prepro_base.py:90): \w with re.UNICODE keeps unicode
# word characters ('café' stays 'café'), '_' and everything else strips
_NON_ALNUM = re.compile(r"([^\w]|_)+", re.UNICODE)


class TokenisedImage(dict):
    """{'filepath': rel path, 'split': str, 'tokens': [[w, ...], ...],
    'image_id': int|str}"""


def clean_tokens(tokens: Sequence[str]) -> List[str]:
    """Default cleaning: lowercase, strip non-alphanumerics
    (prepro_base.py:75-90)."""
    out = []
    for t in tokens:
        t = _NON_ALNUM.sub("", t.lower())
        if t:
            out.append(t)
    return out


def tokenise_karpathy(dataset_json: str, image_dir_map: Optional[Dict[str, str]] = None
                      ) -> List[TokenisedImage]:
    """Parse a Karpathy split JSON (dataset_coco.json format)."""
    with open(dataset_json) as f:
        data = json.load(f)
    out: List[TokenisedImage] = []
    for img in data["images"]:
        subdir = img.get("filepath", "")
        if image_dir_map and subdir in image_dir_map:
            subdir = image_dir_map[subdir]
        rel = pjoin(subdir, img["filename"]) if subdir else img["filename"]
        out.append(TokenisedImage(
            filepath=rel,
            split=img.get("split", "train"),
            tokens=[clean_tokens(s["tokens"]) for s in img["sentences"]],
            image_id=img.get("cocoid", img.get("imgid",
                                               img["filename"])),
        ))
    return out


def convert_split(split: str, include_restval: bool = True) -> str:
    """restval -> train (or dropped); val -> valid (prepro_base.py:28-31)."""
    if split == "restval":
        return "train" if include_restval else "none"
    if split == "val":
        return "valid"
    return split


def train_token_lists(dataset: Iterable[TokenisedImage],
                      include_restval: bool = True
                      ) -> List[List[str]]:
    out = []
    for d in dataset:
        if convert_split(d["split"], include_restval) == "train":
            out.extend(d["tokens"])
    return out


def write_caption_txts(
    dataset: Sequence[TokenisedImage],
    out_dir: str,
    prefix: str,
    caption_len_thres: int = 20,
    include_restval: bool = True,
) -> Dict[str, int]:
    """Per-split `{prefix}_{split}.txt` files, V1 line format
    (prepro_base.py:226-254). Returns per-split line counts."""
    os.makedirs(out_dir, exist_ok=True)
    lines: Dict[str, List[str]] = {"train": [], "valid": [], "test": []}
    for d in dataset:
        split = convert_split(d["split"], include_restval)
        if split not in lines:
            continue
        for toks in d["tokens"]:
            capped = toks[:caption_len_thres]
            lines[split].append(
                f"{d['filepath']},{GO} {' '.join(capped)} {EOS}")
    for split, ls in lines.items():
        with open(pjoin(out_dir, prefix.format(split) + ".txt"), "w") as f:
            f.write("\n".join(ls) + ("\n" if ls else ""))
    # split disjointness assertion (coco_prepro.py:140-146)
    files = {s: {l.split(",")[0] for l in ls} for s, ls in lines.items()}
    assert not (files["train"] & files["valid"])
    assert not (files["train"] & files["test"])
    assert not (files["valid"] & files["test"])
    return {s: len(ls) for s, ls in lines.items()}


def tokenised_word_to_txt_v2(
    dataset: Sequence[TokenisedImage],
    caption_len_thres: int = 20,
    include_restval: bool = True,
) -> Dict[str, List[str]]:
    """V2 line lists: GO/EOS are wrapped BEFORE truncation to thres+2, so
    very long captions lose their EOS (prepro_base.py:257-285; V1 truncates
    the tokens first and always keeps GO/EOS). Returns per-split lists of
    ``filepath,<GO> tokens [...]`` lines."""
    out: Dict[str, List[str]] = {"train": [], "valid": [], "test": []}
    for d in dataset:
        split = convert_split(d["split"], include_restval)
        if split not in out:
            continue
        for toks in d["tokens"]:
            wrapped = [GO] + list(toks) + [EOS]
            out[split].append(
                f"{d['filepath']},{' '.join(wrapped[:caption_len_thres + 2])}")
    return out


def serialise_everything(
    output_filepath: str,
    image_dir: str,
    image_size: Tuple[int, int],
    image_chunk_num: int,
    word_to_txt_dict: Dict[str, List[str]],
    wtoi: Dict[str, int],
    itow: Dict,
) -> str:
    """Packed single-file dataset: captions + vocab + decoded uint8 images
    in one HDF5 (prepro_base.py:288-360). Caption lines are rewritten as
    ``<image index>,<filepath>,<caption>`` against the image array order
    (train ++ valid ++ test uniques). Requires h5py."""
    h5py = require("h5py", "The packed dataset")

    sets = {s: sorted({l.split(",")[0] for l in word_to_txt_dict[s]})
            for s in ("train", "valid", "test")}
    assert not (set(sets["train"]) & set(sets["valid"]))
    assert not (set(sets["train"]) & set(sets["test"]))
    assert not (set(sets["valid"]) & set(sets["test"]))
    all_set = sets["train"] + sets["valid"] + sets["test"]
    idx = {p: i for i, p in enumerate(all_set)}

    from ..data.preprocessing import decode_image_host, _resize_host

    path = f"{output_filepath}.h5"
    with h5py.File(path, "w") as f:
        sdt = h5py.special_dtype(vlen=str)
        f.create_dataset("wtoi", data=json.dumps(wtoi))
        f.create_dataset("itow", data=json.dumps(itow))
        for split in ("valid", "test"):
            d = f.create_dataset(f"filenames_{split}", (len(sets[split]),),
                                 dtype=sdt)
            d[:] = sets[split]
        for split, lines in word_to_txt_dict.items():
            indexed = [f"{idx[l.split(',')[0]]},{l}" for l in lines]
            d = f.create_dataset(split, (len(indexed),), dtype=sdt)
            d[:] = indexed
        h, w = image_size
        d = f.create_dataset(
            "images", (len(all_set), h, w, 3),
            chunks=(image_chunk_num, h, w, 3), dtype="uint8")
        for i, fname in enumerate(all_set):
            img = decode_image_host(pjoin(image_dir, fname))
            d[i] = _resize_host(img, h, w)
    return path


def load_h5_dataset(filepath: str, max_images: Optional[int] = None) -> Dict:
    """Reader for the packed file (prepro_base.py:365-383 test_h5_file)."""
    h5py = require("h5py", "The packed dataset")

    data: Dict = {}
    with h5py.File(filepath, "r") as f:
        data["wtoi"] = json.loads(f["wtoi"][()])
        data["itow"] = json.loads(f["itow"][()])
        for k in ("filenames_valid", "filenames_test", "train", "valid",
                  "test"):
            data[k] = [s.decode() if isinstance(s, bytes) else s
                       for s in f[k][:]]
        # explicit None check: max_images=0 means "no images", not "all"
        data["images"] = (f["images"][:] if max_images is None
                          else f["images"][:max_images])
    return data


def write_vocab(dataset: Sequence[TokenisedImage], out_dir: str,
                prefix: str, *, word_count_thres: int = 5,
                caption_len_thres: int = 20,
                vocab_size: Optional[int] = None,
                include_restval: bool = True) -> Vocabulary:
    vocab = build_vocab(
        train_token_lists(dataset, include_restval),
        word_count_thres=word_count_thres,
        caption_len_thres=caption_len_thres,
        vocab_size=vocab_size)
    vocab.save(pjoin(out_dir, prefix.format("wtoi") + ".json"),
               pjoin(out_dir, prefix.format("itow") + ".json"))
    return vocab


def write_filename_lists(dataset: Sequence[TokenisedImage], out_dir: str,
                         include_restval: bool = True) -> None:
    for split, fname in (("valid", "filenames_valid.txt"),
                         ("test", "filenames_test.txt")):
        files = sorted({d["filepath"] for d in dataset
                        if convert_split(d["split"], include_restval) == split})
        with open(pjoin(out_dir, fname), "w") as f:
            f.write("\n".join(files) + ("\n" if files else ""))


def write_annotation_jsons(dataset: Sequence[TokenisedImage], out_dir: str,
                           name_fmt: str = "annotations_{}.json",
                           include_restval: bool = True) -> None:
    """COCO-format annotation JSONs for valid/test metric scoring (the
    reference ships captions_val2014.json; insta_prepro emits its own,
    insta_prepro.py:223-305)."""
    os.makedirs(out_dir, exist_ok=True)
    for split in ("valid", "test"):
        anns = []
        images = []
        i = 0
        for d in dataset:
            if convert_split(d["split"], include_restval) != split:
                continue
            images.append({"id": d["image_id"]})
            for toks in d["tokens"]:
                anns.append({"image_id": d["image_id"], "id": i,
                             "caption": " ".join(toks)})
                i += 1
        with open(pjoin(out_dir, name_fmt.format(split)), "w") as f:
            json.dump({"annotations": anns, "images": images,
                       "type": "captions", "licenses": [], "info": {}}, f)
