"""ROUGE-L: longest-common-subsequence F-measure with beta = 1.2 (the
port's own copy of comic_tpu.evaluation.rouge).

The COCO evaluator's ROUGE variant (behaviour of the reference's
pycocoevalcap/rouge/rouge.py): per image, precision and recall are each
the MAX over the reference set, then F = (1 + b^2) P R / (R + b^2 P); the
corpus score is the mean over images.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .ids import id_sort_key

BETA = 1.2


def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    """O(len(a) * len(b)) dynamic program with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        curr = [0]
        for j, y in enumerate(b, 1):
            if x == y:
                curr.append(prev[j - 1] + 1)
            else:
                curr.append(max(prev[j], curr[-1]))
        prev = curr
    return prev[-1]


def rouge_l_sentence(hyp: str, refs: Sequence[str]) -> float:
    hyp_tokens = hyp.split()
    prec, rec = [], []
    for ref in refs:
        ref_tokens = ref.split()
        n = lcs_length(hyp_tokens, ref_tokens)
        prec.append(n / len(hyp_tokens) if hyp_tokens else 0.0)
        rec.append(n / len(ref_tokens) if ref_tokens else 0.0)
    p, r = max(prec), max(rec)
    if p == 0 or r == 0:
        return 0.0
    return ((1 + BETA ** 2) * p * r) / (r + BETA ** 2 * p)


def rouge_l(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    scores = [rouge_l_sentence(res[k][0], gts[k])
              for k in sorted(gts, key=id_sort_key)]
    corpus = sum(scores) / len(scores) if scores else 0.0
    return corpus, scores


class RougeScorer:
    def compute_score(self, gts: Dict, res: Dict):
        return rouge_l(gts, res)

    def method(self) -> str:
        return "Rouge"
