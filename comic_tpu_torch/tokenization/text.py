"""Caption ids <-> text (the port's own copy of
comic_tpu.tokenization.text; reference ``id_to_caption``,
src/infer_fn.py:46-75, and the caption encoders of
manager_image_caption.py:206-228,263-281,334-357,477-509)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .radix import RadixCodec
from .vocab import EOS, GO, Vocabulary


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


def encode_caption_tokens(
    tokens: Sequence[str],
    token_type: str,
    vocab: Vocabulary,
    radix_base: Optional[int] = None,
) -> np.ndarray:
    """Token list (already including <GO>/<EOS>) -> int32 id array.

    word: direct lookup with <UNK> fallback; radix: per-word digit
    expansion; char: interior tokens re-joined with spaces and split into
    characters, then wrapped in GO/EOS.
    """
    if token_type == "word":
        return np.asarray([vocab.id(t) for t in tokens], dtype=np.int32)
    if token_type == "radix":
        codec = RadixCodec(len(vocab), radix_base)
        return codec.encode_caption(
            tokens, vocab.wtoi, vocab.radix_map(radix_base)).astype(np.int32)
    if token_type == "char":
        interior = " ".join(tokens[1:-1])
        ids = [vocab.wtoi[ch] for ch in interior]
        return np.asarray([vocab.go_id] + ids + [vocab.eos_id],
                          dtype=np.int32)
    raise ValueError(f"Unknown token_type: {token_type}")


def caption_strings_to_batched_ids(
    captions: Sequence[str],
    token_type: str,
    vocab: Vocabulary,
    radix_base: Optional[int] = None,
    pad_id: int = -1,
) -> np.ndarray:
    """Re-tokenize hypothesis strings into a padded (N, longest) int32 id
    batch: the XE targets of the SCST step (``captions_to_batched_ids``,
    manager_image_caption.py:477-509).

    char: characters outside the vocabulary are dropped, as comic_tpu does
    (a hypothesis can render a special token such as <GO> literally,
    whose '<' and '>' the char vocabulary lacks; the reference would
    KeyError). word and radix wrap the words in <GO>/<EOS> and encode them
    as encode_caption_tokens does (<UNK> for unknown words).
    """
    rows: List[np.ndarray] = []
    for cap in captions:
        if token_type == "char":
            ids = [vocab.wtoi[ch] for ch in cap if ch in vocab.wtoi]
            row = np.asarray([vocab.go_id] + ids + [vocab.eos_id],
                             dtype=np.int32)
        else:
            toks = [GO] + cap.split() + [EOS]
            row = encode_caption_tokens(toks, token_type, vocab, radix_base)
        rows.append(row)
    max_len = max(r.shape[0] for r in rows)
    if max_len <= 1:
        raise ValueError("All hypotheses are empty.")
    out = np.full((len(rows), max_len), pad_id, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out
