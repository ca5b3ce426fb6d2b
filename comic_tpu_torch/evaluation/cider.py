"""CIDEr and CIDEr-D consensus metrics (the port's own copy of
comic_tpu.evaluation.cider).

The two variants the reference relies on (Vedantam et al., CVPR 2015; the
reference's common/scst/cider_ruotianluo/ and
pycocoevalcap/cider/ scorers):

  - tf-idf vectors per n (1..4): g_n[w] = count(w) * (log N - log max(df_w, 1));
  - CIDEr: mean over refs of the cosine similarity, averaged over n, x10;
  - CIDEr-D: the numerator clips the hypothesis vector to the reference
    vector (min(g_h, g_r) . g_r), times a Gaussian length penalty
    exp(-(len_h - len_r)^2 / (2 * 6^2)), averaged over refs and n, x10;
  - document frequency either from the evaluated corpus ('corpus' mode)
    or from the SCST IDF cache (``df`` dict + ``ref_len`` = RAW image count
    N; the log is applied here, as ciderD_scorer.py:82 does).

Reference quirk kept: the "length" of the CIDEr-D Gaussian penalty is the
BIGRAM token count (``if n == 1: length += term_freq``,
ciderD_scorer.py:151-152), i.e. max(len(words) - 1, 0). It differs from
the word count only for sentences of fewer than 2 words, which SCST
rollouts can produce (EOS at step 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ids import id_sort_key
from .ngrams import Ngram, document_frequency, ngram_counts

SIGMA = 6.0
MAX_N = 4


def _tfidf_vec(tokens: List[str], df: Dict[Ngram, float], log_n: float
               ) -> Tuple[List[Dict[Ngram, float]], List[float], int]:
    """-> (per-n sparse vectors, per-n norms, unigram length)."""
    vecs: List[Dict[Ngram, float]] = [dict() for _ in range(MAX_N)]
    norms = [0.0] * MAX_N
    for g, c in ngram_counts(tokens, MAX_N).items():
        idf = log_n - math.log(max(df.get(g, 0.0), 1.0))
        n = len(g) - 1
        v = c * idf
        vecs[n][g] = v
        norms[n] += v * v
    return vecs, [math.sqrt(x) for x in norms], len(tokens)


class _CiderBase:
    def __init__(self, df: Optional[object] = None):
        """df: None -> document frequencies from each call's gts; or an
        IDF cache dict {'document_frequency', 'ref_len'}."""
        if isinstance(df, dict):
            self.df = df["document_frequency"]
            # the cache stores the raw corpus size (prepro_ngrams.py:150);
            # the scorer applies the log (ciderD_scorer.py:82)
            self.log_n = math.log(float(df["ref_len"]))
        else:
            self.df = None
            self.log_n = None

    def _resolve_df(self, gts: Dict):
        if self.df is not None:
            return self.df, self.log_n
        refs_per_image = [gts[k] for k in gts]
        return (document_frequency(refs_per_image, MAX_N),
                math.log(max(len(refs_per_image), 1)))

    def compute_score(self, gts: Dict, res: Dict
                      ) -> Tuple[float, np.ndarray]:
        df, log_n = self._resolve_df(gts)
        scores = []
        for k in sorted(gts, key=id_sort_key):
            hyp_vec, hyp_norm, hyp_len = _tfidf_vec(
                res[k][0].split(), df, log_n)
            per_n = np.zeros(MAX_N)
            for ref in gts[k]:
                ref_vec, ref_norm, ref_len = _tfidf_vec(
                    ref.split(), df, log_n)
                per_n += self._sim(hyp_vec, hyp_norm, hyp_len,
                                   ref_vec, ref_norm, ref_len)
            per_n /= max(len(gts[k]), 1)
            scores.append(float(np.mean(per_n)) * 10.0)
        arr = np.asarray(scores)
        return float(arr.mean()) if len(arr) else 0.0, arr


class Cider(_CiderBase):
    """Plain CIDEr: average cosine similarity."""

    def _sim(self, hv, hn, hl, rv, rn, rl) -> np.ndarray:
        out = np.zeros(MAX_N)
        for n in range(MAX_N):
            if hn[n] == 0 or rn[n] == 0:
                continue
            dot = sum(v * rv[n].get(g, 0.0) for g, v in hv[n].items())
            out[n] = dot / (hn[n] * rn[n])
        return out

    def method(self) -> str:
        return "CIDEr"


class CiderD(_CiderBase):
    """CIDEr-D: clipped numerator + Gaussian length penalty."""

    def _sim(self, hv, hn, hl, rv, rn, rl) -> np.ndarray:
        # bigram-count lengths (reference quirk, see the module docstring)
        delta = float(max(hl - 1, 0) - max(rl - 1, 0))
        penalty = math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        out = np.zeros(MAX_N)
        for n in range(MAX_N):
            if hn[n] == 0 or rn[n] == 0:
                continue
            dot = sum(min(v, rv[n].get(g, 0.0)) * rv[n].get(g, 0.0)
                      for g, v in hv[n].items())
            out[n] = dot / (hn[n] * rn[n]) * penalty
        return out

    def method(self) -> str:
        return "CIDEr-D"
