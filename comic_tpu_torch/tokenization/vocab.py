"""Vocabulary (the port's own copy of comic_tpu.tokenization.vocab, the
parts serving needs).

Id layout (reference prepro_base.py:149-223): <PAD> = -1, then words in
descending frequency, then <UNK>, <GO>, <EOS>. itow keys arrive as strings
from the JSON round-trip (reference manager_image_caption.py:98-108).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

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
    def go_id(self) -> int:
        return self.wtoi[GO]

    @property
    def eos_id(self) -> int:
        return self.wtoi[EOS]

    @classmethod
    def from_str_itow(cls, wtoi: Dict[str, int],
                      itow: Dict[str, str]) -> "Vocabulary":
        """Build from reference-style dicts (itow keys may be str)."""
        return cls(
            {k: int(v) for k, v in wtoi.items()},
            {int(k): v for k, v in itow.items()},
        )
