"""The SCST reward scorer (the port's own copy of
comic_tpu.evaluation.scorers; reference common/scst/scorers.py:29-171).

One object holds CIDEr-D (with the cached training-corpus IDF), CIDEr and
BLEU; ``get_hypo_scores`` scores [greedy ‖ samples] jointly against the
references, combines the metrics by the configured weights, and returns
per-hypothesis scores with the greedy scores tiled across beams.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .bleu import BleuScorer
from .cider import Cider
from .cider_native import NativeCiderD, make_ciderd
from .ngrams import load_idf_cache


class CaptionScorer:
    def __init__(self, path_to_cached_tokens: Optional[str],
                 metric_weights: Dict[str, Union[float, Sequence[float]]]):
        """metric_weights e.g. {'ciderD': 1.0, 'bleu': [0, 0, 0, 2]}
        (reference defaults, src/train.py:141-146). ``ciderd_impl`` says
        which CIDEr-D runs: 'native' (csrc/ciderd.cpp) or 'python' (no
        toolchain; the same scores)."""
        cache = (load_idf_cache(path_to_cached_tokens)
                 if path_to_cached_tokens else None)
        self._scorers = {
            "ciderD": make_ciderd(df=cache),
            "cider": Cider(df=cache),
            "bleu": BleuScorer(4),
        }
        self.ciderd_impl = ("native" if isinstance(self._scorers["ciderD"],
                                                   NativeCiderD)
                            else "python")
        self.weights = metric_weights

    def get_hypo_scores(self, refs: List[List[str]],
                        sample: List[List[str]],
                        greedy: List[List[str]],
                        best_hypo_only: bool = False
                        ) -> Tuple[List[List[str]], np.ndarray, np.ndarray]:
        """refs[i]: reference strings of image i; greedy[i] = [hypothesis];
        sample beam-major ([im0_b0 ... imN_b0, im0_b1 ...]). Returns
        (hypos, score_sample, score_greedy), greedy tiled x beams."""
        num_sample, num_greedy = len(sample), len(greedy)
        if num_sample % num_greedy:
            raise ValueError("len(sample) must be a multiple of len(greedy)")
        multiple = num_sample // num_greedy

        gts: Dict[int, List[str]] = {}
        res: Dict[int, List[str]] = {}
        for idx in range(num_sample):
            if idx < num_greedy:
                res[idx] = greedy[idx]
                gts[idx] = refs[idx]
            res[idx + num_greedy] = sample[idx]
            gts[idx + num_greedy] = refs[idx % num_greedy]

        combined: Optional[np.ndarray] = None
        for name, scorer in self._scorers.items():
            w = self.weights.get(name)
            if w is None or np.max(np.atleast_1d(w)) <= 0:
                continue
            _, sc = scorer.compute_score(gts, res)
            if isinstance(w, (list, tuple)):
                part = sum(np.asarray(sc[i]) * w[i] for i in range(len(w)))
            else:
                part = np.asarray(sc) * float(w)
            combined = part if combined is None else combined + part
        if combined is None:
            raise ValueError("No metric has a positive weight.")

        sc_greedy = combined[:num_greedy]
        sc_sample = combined[num_greedy:]

        if num_sample > num_greedy and best_hypo_only:
            sc_sample = sc_sample.reshape(multiple, num_greedy)
            best_beam = np.argmax(sc_sample, axis=0)
            final_hypo = [sample[i + num_greedy * int(best_beam[i])]
                          for i in range(num_greedy)]
            sc_sample = np.amax(sc_sample, axis=0)
        else:
            if num_sample > num_greedy:
                sc_greedy = np.concatenate([sc_greedy] * multiple)
            final_hypo = sample
        return final_hypo, sc_sample, sc_greedy
