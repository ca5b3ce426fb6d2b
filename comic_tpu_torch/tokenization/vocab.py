"""Vocabulary construction and (de)serialization (the port's own copy of
comic_tpu.tokenization.vocab).

Id layout (reference prepro_base.py:149-223): <PAD> = -1, then words in
descending frequency, then <UNK>, <GO>, <EOS>. JSON files
``{pattern}_wtoi.json`` / ``{pattern}_itow.json``; itow keys arrive as
strings from the JSON round-trip (reference manager_image_caption.py:98-108).
The char vocabulary is built in code (reference
manager_image_caption.py:299-331).
"""

from __future__ import annotations

import json
import string
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence

PAD = "<PAD>"
UNK = "<UNK>"
GO = "<GO>"
EOS = "<EOS>"


@dataclass
class Vocabulary:
    """Word <-> id maps with the reference's id layout."""

    wtoi: Dict[str, int]
    itow: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        if not self.itow:
            self.itow = {i: w for w, i in self.wtoi.items()}

    def __len__(self) -> int:
        return len(self.wtoi)

    @property
    def pad_id(self) -> int:
        return self.wtoi[PAD]

    @property
    def unk_id(self) -> int:
        return self.wtoi[UNK]

    @property
    def go_id(self) -> int:
        return self.wtoi[GO]

    @property
    def eos_id(self) -> int:
        return self.wtoi[EOS]

    def word(self, idx: int) -> str:
        return self.itow[int(idx)]

    def id(self, word: str) -> int:
        return self.wtoi.get(word, self.wtoi[UNK])

    def radix_map(self, base: int) -> Dict[str, list]:
        """Cached token -> radix-digit-list map (building it is O(vocab))."""
        cache = self.__dict__.setdefault("_radix_maps", {})
        if base not in cache:
            from .radix import RadixCodec

            cache[base] = RadixCodec(len(self), base).build_radix_wtoi(
                self.wtoi)
        return cache[base]

    def save(self, wtoi_path: str, itow_path: str) -> None:
        with open(wtoi_path, "w") as f:
            json.dump(self.wtoi, f)
        with open(itow_path, "w") as f:
            json.dump({str(k): v for k, v in self.itow.items()}, f)

    @classmethod
    def load(cls, wtoi_path: str,
             itow_path: Optional[str] = None) -> "Vocabulary":
        with open(wtoi_path) as f:
            wtoi = {k: int(v) for k, v in json.load(f).items()}
        itow = None
        if itow_path is not None:
            with open(itow_path) as f:
                itow = {int(k): v for k, v in json.load(f).items()}
        return cls(wtoi, itow or {})

    @classmethod
    def from_str_itow(cls, wtoi: Dict[str, int],
                      itow: Dict[str, str]) -> "Vocabulary":
        """Build from reference-style dicts (itow keys may be str)."""
        return cls(
            {k: int(v) for k, v in wtoi.items()},
            {int(k): v for k, v in itow.items()},
        )


def build_vocab(
    train_token_lists: Iterable[Sequence[str]],
    word_count_thres: int = 5,
    caption_len_thres: int = 20,
    vocab_size: Optional[int] = None,
    pad_value: int = -1,
    include_go_eos: bool = True,
) -> Vocabulary:
    """Count words in training captions and assign ids.

    Words are counted only up to ``caption_len_thres`` tokens per caption,
    kept if ``count >= word_count_thres`` (or the top ``vocab_size`` when a
    fixed size is asked for), and ordered by descending (count, word)
    (reference prepro_base.py:179-223).
    """
    if pad_value < -1:
        raise ValueError("pad_value must be >= -1")
    counts: Dict[str, int] = {}
    for tokens in train_token_lists:
        for w_count, w in enumerate(tokens):
            if w_count < caption_len_thres:
                counts[w] = counts.get(w, 0) + 1

    cw = sorted(((c, w) for w, c in counts.items()), reverse=True)
    if vocab_size is None:
        vocab = [w for c, w in cw if c >= word_count_thres]
    else:
        vocab = [w for _, w in cw[:vocab_size]]

    wtoi: Dict[str, int] = {PAD: pad_value}
    idx = pad_value + 1
    for w in vocab:
        wtoi[w] = idx
        idx += 1
    wtoi[UNK] = idx
    if include_go_eos:
        wtoi[GO] = idx + 1
        wtoi[EOS] = idx + 2
    return Vocabulary(wtoi)


def build_char_vocab(pad_value: int = -1) -> Vocabulary:
    """Synthetic character vocabulary: <PAD>=pad_value, ' ', digits 0-9,
    a-z, then <GO> and <EOS> at ``len(ctoi)`` at insertion time, which
    leaves one unused id between 'z' and <GO> when pad_value == -1 (kept
    for id compatibility with the reference)."""
    ctoi: Dict[str, int] = {}
    itoc: Dict[int, str] = {}
    for idx, ch in enumerate([PAD, " "]
                             + list(string.digits + string.ascii_lowercase),
                             start=pad_value):
        ctoi[ch] = idx
        itoc[idx] = ch
    ctoi[GO] = len(ctoi)
    ctoi[EOS] = len(ctoi)
    itoc[len(itoc)] = GO
    itoc[len(itoc)] = EOS
    return Vocabulary(ctoi, itoc)
