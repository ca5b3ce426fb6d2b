"""Generated ids -> caption text (the port's own copy of
comic_tpu.tokenization.text.ids_to_captions; reference
``id_to_caption``, src/infer_fn.py:46-75)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .radix import RadixCodec
from .vocab import Vocabulary


def ids_to_captions(
    ids: np.ndarray,
    token_type: str,
    vocab: Vocabulary,
    radix_base: Optional[int] = None,
) -> List[str]:
    """Decode a (batch, time) int array of generated ids into captions.

    - radix: digits -> fixed-width groups -> word ids (infer_fn.py:50-63)
    - word:  drop ids < 0 and <EOS>, join with spaces (infer_fn.py:65-74)
    - char:  same but join without spaces

    Ids that map to no vocabulary entry are dropped, as comic_tpu does
    (an untrained checkpoint can emit them; the reference would KeyError).
    """
    ids = np.asarray(ids)
    if ids.ndim == 1:
        ids = ids[None]
    captions: List[str] = []
    if token_type == "radix":
        codec = RadixCodec(len(vocab), radix_base)
        for row in ids:
            wids = codec.decode_ids(row.tolist())
            captions.append(" ".join(vocab.itow[w] for w in wids
                                     if w in vocab.itow))
    elif token_type in ("word", "char"):
        eos = vocab.eos_id
        joiner = " " if token_type == "word" else ""
        for row in ids:
            toks = [vocab.itow[w] for w in row.tolist()
                    if w >= 0 and w != eos and w in vocab.itow]
            captions.append(joiner.join(toks))
    else:
        raise ValueError(f"Unknown token_type: {token_type}")
    return captions
