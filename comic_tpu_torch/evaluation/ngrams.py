"""N-gram utilities shared by the caption metrics, plus the SCST IDF cache
(the port's own copy of comic_tpu.evaluation.ngrams).

The IDF cache is the reference's offline ``prepro_ngrams`` artifact
(common/scst/prepro_ngrams.py:24-156): a pickle
``{"document_frequency": {ngram: df}, "ref_len": N}`` computed over the
training references, read by CIDEr-D during SCST (train_fn.py:192-201,
ciderD_scorer.py:78-84). The on-disk ``ref_len`` is the RAW image count
(prepro_ngrams.py:150 stores ``len(refs_words)``); the scorer applies
``log`` at load (ciderD_scorer.py:82). Caches written by the reference,
by comic_tpu and by this module are interchangeable.
"""

from __future__ import annotations

import math
import pickle
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Ngram = Tuple[str, ...]


def ngram_counts(tokens: Sequence[str], max_n: int = 4) -> Dict[Ngram, int]:
    counts: Dict[Ngram, int] = defaultdict(int)
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i: i + n])] += 1
    return dict(counts)


def count_sentences(sentences: Iterable[str], max_n: int = 4
                    ) -> List[Dict[Ngram, int]]:
    return [ngram_counts(s.split(), max_n) for s in sentences]


def document_frequency(refs_per_image: Sequence[Sequence[str]], max_n: int = 4
                       ) -> Dict[Ngram, float]:
    """df[ngram] = number of images in whose reference set it appears."""
    df: Dict[Ngram, float] = defaultdict(float)
    for refs in refs_per_image:
        seen = set()
        for ref in refs:
            seen.update(ngram_counts(ref.split(), max_n).keys())
        for g in seen:
            df[g] += 1.0
    return dict(df)


def build_idf_cache(refs_per_image: Sequence[Sequence[str]], max_n: int = 4
                    ) -> Dict[str, object]:
    return {
        # a defaultdict(float), as the reference artifact
        # (prepro_ngrams.py:67): the reference scorer indexes it with []
        # and relies on the 0.0 default for unseen ngrams
        # (ciderD_scorer.py:143)
        "document_frequency": defaultdict(
            float, document_frequency(refs_per_image, max_n)),
        # raw count, as the reference artifact (prepro_ngrams.py:150)
        "ref_len": float(len(refs_per_image)),
    }


def save_idf_cache(path: str, cache: Dict[str, object]) -> None:
    with open(path, "wb") as f:
        pickle.dump(cache, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_idf_cache(path: str) -> Dict[str, object]:
    with open(path, "rb") as f:
        try:
            cache = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            cache = pickle.load(f, encoding="latin1")
    # Legacy format: comic_tpu's early caches stored ref_len = log(N). A
    # raw count is integral by construction, log(N) is not for N > 1, so a
    # fractional ref_len is a legacy cache: convert it loudly instead of
    # computing log(log(N)) downstream.
    ref_len = cache.get("ref_len")
    if isinstance(ref_len, float) and abs(ref_len - round(ref_len)) > 1e-9:
        cache["ref_len"] = math.exp(ref_len)
        print(f"NOTE: IDF cache {path!r} has non-integral ref_len "
              f"{ref_len:.6f} — a legacy cache storing log(N); converted "
              f"to the raw-count format (N = {cache['ref_len']:.1f}). "
              f"Regenerate the cache to silence this.")
    return cache
