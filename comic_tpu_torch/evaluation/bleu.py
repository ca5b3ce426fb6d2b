"""Corpus and per-image BLEU-1..4 (the port's own copy of
comic_tpu.evaluation.bleu).

The BLEU variant the COCO caption evaluator uses (behaviour of the
reference's pycocoevalcap/bleu/bleu_scorer.py):

  - clipped n-gram precision p_k = (correct_k + tiny) / (guess_k + small)
    with tiny=1e-15, small=1e-9;
  - cumulative geometric mean: BLEU-k = (prod_{j<=k} p_j) ** (1/k);
  - brevity penalty exp(1 - 1/ratio) when ratio < 1, where
    ratio = (testlen + tiny) / (reflen + small);
  - effective reference length 'closest' (per sentence: the ref length
    nearest the hypothesis length, ties -> shorter);
  - per-image scores use each sentence's own counts and ratio; corpus
    scores pool counts and lengths over all sentences.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from .ids import id_sort_key
from .ngrams import ngram_counts

_TINY = 1e-15
_SMALL = 1e-9


def _closest_reflen(ref_lens: Sequence[int], test_len: int) -> int:
    return min((abs(n - test_len), n) for n in ref_lens)[1]


def _clipped_counts(hyp_tokens: List[str],
                    ref_counts: Dict[tuple, int], max_n: int
                    ) -> Tuple[List[int], List[int]]:
    guess = [max(0, len(hyp_tokens) - k) for k in range(max_n)]
    correct = [0] * max_n
    for g, c in ngram_counts(hyp_tokens, max_n).items():
        correct[len(g) - 1] += min(c, ref_counts.get(g, 0))
    return guess, correct


def _max_ref_counts(refs: Sequence[str], max_n: int) -> Dict[tuple, int]:
    out: Dict[tuple, int] = {}
    for ref in refs:
        for g, c in ngram_counts(ref.split(), max_n).items():
            out[g] = max(out.get(g, 0), c)
    return out


def _bleus_from_stats(guess, correct, test_len, ref_len, max_n):
    bleus = []
    prod = 1.0
    for k in range(max_n):
        prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
        bleus.append(prod ** (1.0 / (k + 1)))
    ratio = (test_len + _TINY) / (ref_len + _SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


def bleu(gts: Dict, res: Dict, max_n: int = 4
         ) -> Tuple[List[float], List[List[float]]]:
    """-> (corpus [BLEU-1..max_n], per-image lists per n)."""
    total_guess = [0] * max_n
    total_correct = [0] * max_n
    total_testlen = 0
    total_reflen = 0.0
    per_image: List[List[float]] = [[] for _ in range(max_n)]

    for key in sorted(gts, key=id_sort_key):
        refs = gts[key]
        hyp_tokens = res[key][0].split()
        ref_counts = _max_ref_counts(refs, max_n)
        guess, correct = _clipped_counts(hyp_tokens, ref_counts, max_n)
        test_len = len(hyp_tokens)
        ref_len = _closest_reflen([len(r.split()) for r in refs], test_len)

        sent = _bleus_from_stats(guess, correct, test_len, ref_len, max_n)
        for k in range(max_n):
            per_image[k].append(sent[k])
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]
        total_testlen += test_len
        total_reflen += ref_len

    corpus = _bleus_from_stats(total_guess, total_correct, total_testlen,
                               total_reflen, max_n)
    return corpus, per_image


class BleuScorer:
    """pycocoevalcap-compatible interface: compute_score(gts, res)."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        return bleu(gts, res, self.n)

    def method(self) -> str:
        return "Bleu"
