"""Radix (base-N) token codec (the port's own copy of
comic_tpu.tokenization.radix).

Every word id is spelled as a fixed-width sequence of base-N digits; the
decoder's softmax is ``N + 2`` wide (digits plus GO/EOS).

Behavioral contract (reference semantics):
  - ``number_to_base`` — reference common/ops.py:25-40
  - fixed-width digit encoding with GO=base, EOS=base+1, PAD=-1 —
    reference common/inputs/manager_image_caption.py:231-262
  - digit-sequence -> word-id decode incl. truncation / out-of-vocab rules —
    reference src/infer_fn.py:36-63
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

PAD_ID = -1


def number_to_base(n: int, base: int) -> List[int]:
    """Convert a base-10 integer to a list of base-N digits (MSB first).

    ``0`` encodes as ``[0]``. Negative inputs keep their sign on every
    digit (reference common/ops.py:25-40).
    """
    if base < 2:
        raise ValueError("Base cannot be less than 2.")
    if n == 0:
        return [0]
    sign = -1 if n < 0 else 1
    n = abs(n)
    digits = []
    while n:
        digits.append(sign * (n % base))
        n //= base
    return digits[::-1]


def base_arr_to_int(digits: Sequence[int], base: int) -> int:
    """MSB-first base-N digit sequence -> base-10 integer
    (reference ``_baseN_arr_to_dec``, src/infer_fn.py:36-43)."""
    result = 0
    for d in digits:
        result = result * base + int(d)
    return result


class RadixCodec:
    """Fixed-width base-N word-id codec.

    Args:
      vocab_len: number of vocabulary entries INCLUDING the
        <PAD>/<UNK>/<GO>/<EOS> specials (the digit width is sized off the
        full dict, reference manager_image_caption.py:240).
      base: radix base (256 for COMIC-256).
    """

    def __init__(self, vocab_len: int, base: int):
        if base < 2:
            raise ValueError("Base cannot be less than 2.")
        self.base = base
        self.vocab_len = vocab_len
        #: digits per word (fixed width)
        self.word_len = len(number_to_base(vocab_len, base))
        #: radix-plane special ids
        self.go_id = base
        self.eos_id = base + 1
        self.pad_id = PAD_ID
        #: decoder softmax width: digits + GO + EOS
        self.softmax_size = base + 2

    def encode_word_id(self, word_id: int) -> List[int]:
        """word id -> fixed-width MSB-first digits, zero-padded on the
        left."""
        digits = number_to_base(word_id, self.base)
        return [0] * (self.word_len - len(digits)) + digits

    def build_radix_wtoi(self, wtoi: Dict[str, int]) -> Dict[str, List[int]]:
        """Every vocab token -> its digit list: <GO> -> [base], <EOS> ->
        [base+1], <PAD> -> [-1], words -> fixed-width digits (reference
        manager_image_caption.py:243-256). Requires <PAD> == -1."""
        if wtoi["<PAD>"] != PAD_ID:
            raise ValueError("Radix codec requires <PAD> == -1.")
        out: Dict[str, List[int]] = {}
        for tok, idx in wtoi.items():
            if tok == "<GO>":
                out[tok] = [self.go_id]
            elif tok == "<EOS>":
                out[tok] = [self.eos_id]
            elif tok == "<PAD>":
                out[tok] = [self.pad_id]
            else:
                out[tok] = self.encode_word_id(idx)
        return out

    def encode_caption(self, tokens: Sequence[str], wtoi: Dict[str, int],
                       radix_wtoi: Optional[Dict[str, List[int]]] = None
                       ) -> np.ndarray:
        """Token list (incl. <GO>/<EOS>) -> concatenated digit ids; unknown
        tokens take <UNK>'s digits. Pass a prebuilt ``radix_wtoi`` when
        encoding many captions (building it is O(vocab))."""
        if radix_wtoi is None:
            radix_wtoi = self.build_radix_wtoi(wtoi)
        unk = radix_wtoi["<UNK>"]
        parts = [radix_wtoi.get(t, unk) for t in tokens]
        return np.concatenate([np.asarray(p, dtype=np.int32) for p in parts])

    def decode_ids(self, ids: Sequence[int]) -> List[int]:
        """Digit-id sequence -> word ids (reference infer_fn.py:50-63).

        Keep only true digits ``0 <= d < base`` (drops GO/EOS/PAD); when
        the count is not a multiple of ``word_len``, drop exactly ONE
        trailing digit and then stride in ``word_len`` groups, so a still
        incomplete trailing group decodes as a SHORT word. Decoded ids
        ``>= vocab_len`` are discarded.
        """
        row = [int(d) for d in ids if 0 <= int(d) < self.base]
        if len(row) % self.word_len != 0:
            row = row[:-1]
        words = []
        for j in range(0, len(row), self.word_len):
            wid = base_arr_to_int(row[j : j + self.word_len], self.base)
            if wid < self.vocab_len:
                words.append(wid)
        return words
