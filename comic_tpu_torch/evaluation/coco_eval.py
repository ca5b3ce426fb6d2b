"""COCO-style caption evaluation: annotation loading, scoring, artifacts
(the port's own copy of comic_tpu.evaluation.coco_eval).

Takes the place of the reference's pycocotools COCO + COCOEvalCap
(pycocoevalcap/eval.py:9-75):

  - reads COCO annotation JSON ({"annotations": [{image_id, caption}]})
    and COCO result JSON ([{image_id, caption}]);
  - PTB-tokenizes both (the CoreNLP jar when Java and the jar are there,
    else the Python fallback);
  - runs BLEU-1..4, ROUGE-L and CIDEr in process, METEOR and SPICE through
    Java when available;
  - gives corpus and per-image scores and writes the reference's score
    artifacts: metric_scores.txt, metric_scores.csv and the per-image
    detailed JSON sorted by CIDEr (infer_fn.py:236-290).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .bleu import BleuScorer
from .cider_native import make_ciderd
from .ids import id_sort_key
from .java_metrics import MeteorScorer, SpiceScorer
from .rouge import RougeScorer
from .tokenizer import CORENLP_JAR, PTBTokenizer, java_available

METRIC_ORDER = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                "ROUGE_L", "CIDEr", "SPICE"]


def _image_id(value):
    """COCO ids are ints; insta-style ids are arbitrary strings — coerce
    only when numeric so both sides key identically."""
    if isinstance(value, int):
        return value
    s = str(value)
    return int(s) if s.lstrip("-").isdigit() else s


def load_annotations(path: str) -> Dict[object, List[dict]]:
    with open(path) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    gts: Dict[object, List[dict]] = {}
    for a in anns:
        gts.setdefault(_image_id(a["image_id"]), []).append(
            {"caption": a["caption"]})
    return gts


def load_results(path: str) -> Dict[object, List[dict]]:
    with open(path) as f:
        data = json.load(f)
    res: Dict[object, List[dict]] = {}
    for a in data:
        res[_image_id(a["image_id"])] = [{"caption": a["caption"]}]
    return res


class CocoCaptionEvaluator:
    """COCOEvalCap's counterpart."""

    def __init__(self, jar_dir: str = "", require_ptb_jar: bool = False):
        """require_ptb_jar: refuse to score through the Python PTB
        fallback (parity runs, where tokenizer skew against the
        reference's CoreNLP jar could eat the CIDEr budget)."""
        self.jar_dir = jar_dir
        self.require_ptb_jar = require_ptb_jar
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[object, Dict[str, float]] = {}

    def evaluate(self, gts_raw: Dict[object, List[dict]],
                 res_raw: Dict[object, List[dict]]) -> Dict[str, float]:
        # restrict gts to the scored images (loadRes semantics)
        keys = [k for k in res_raw if k in gts_raw]
        if res_raw and not keys:
            raise ValueError(
                "No result image id matches the annotations — the scores "
                "would silently be all zeros. Typical cause: id type/format "
                "skew (int COCO ids vs string filenames). Result ids look "
                f"like {list(res_raw)[:3]!r}, annotation ids like "
                f"{list(gts_raw)[:3]!r}.")
        if len(keys) < len(res_raw):
            print(f"WARNING: {len(res_raw) - len(keys)} of {len(res_raw)} "
                  "result images have no annotation entry and are dropped "
                  "from scoring (pycocotools loadRes would assert).",
                  file=sys.stderr)
        if not java_available(self.jar_dir):
            if self.require_ptb_jar:
                raise RuntimeError(
                    "PTB jar required but unavailable: this evaluation was "
                    "marked as a parity run (require_ptb_jar), and scoring "
                    "through the Python tokenizer fallback could shift "
                    "BLEU/CIDEr beyond the parity budget. Provide "
                    f"--jar_dir containing {CORENLP_JAR!r} plus a java "
                    "runtime, or drop the requirement.")
            print("WARNING: CoreNLP PTB jar unavailable — scoring through "
                  "the Python tokenizer fallback (PTB-approximate; see "
                  "evaluation/tokenizer.py). Do NOT use these scores for "
                  "reference-parity claims.", file=sys.stderr)
        tok = PTBTokenizer(self.jar_dir)
        gts = tok.tokenize({k: gts_raw[k] for k in keys})
        res = tok.tokenize({k: res_raw[k] for k in keys})
        # tokenize() decides per call: a jar that passed java_available but
        # fell back still cannot leak into a parity run
        if self.require_ptb_jar and tok.used_fallback:
            raise RuntimeError(
                "PTB jar required but tokenization used the Python "
                "fallback — parity scores would be invalid.")

        # the coco-caption "CIDEr" is the CIDEr-D formula in corpus-df mode
        # (min-clipping and the Gaussian length penalty of the vendored
        # cider_scorer.py), so the headline CIDEr is scored with CIDEr-D
        scorers = [
            (BleuScorer(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (RougeScorer(), "ROUGE_L"),
            (make_ciderd(), "CIDEr"),
        ]
        meteor = MeteorScorer(self.jar_dir)
        if meteor.available():
            scorers.append((meteor, "METEOR"))
        spice = SpiceScorer(self.jar_dir)
        if spice.available():
            scorers.append((spice, "SPICE"))

        ordered_keys = sorted(gts.keys(), key=id_sort_key)
        gts_o = {k: gts[k] for k in ordered_keys}
        res_o = {k: res[k] for k in ordered_keys}

        for scorer, name in scorers:
            score, per_image = scorer.compute_score(gts_o, res_o)
            if isinstance(name, list):
                for n, s, per in zip(name, score, per_image):
                    self._record(n, s, per, ordered_keys)
            else:
                if scorer.method() == "SPICE":
                    per_image = [float(s["All"]["f"]) for s in per_image]
                self._record(name, score, per_image, ordered_keys)
        return dict(self.eval)

    def _record(self, name: str, score: float, per_image: Sequence[float],
                keys: Sequence) -> None:
        self.eval[name] = float(score)
        for k, s in zip(keys, per_image):
            self.img_to_eval.setdefault(k, {"image_id": k})[name] = float(s)


def evaluate_captions(annotations_file: str, results_file: str,
                      jar_dir: str = "", require_ptb_jar: bool = False
                      ) -> Tuple[Dict[str, float], Dict[object, Dict]]:
    """(corpus scores, per-image scores) for a result JSON
    (infer_fn.py:295-315)."""
    gts = load_annotations(annotations_file)
    res = load_results(results_file)
    ev = CocoCaptionEvaluator(jar_dir, require_ptb_jar=require_ptb_jar)
    scores = ev.evaluate(gts, res)
    return scores, ev.img_to_eval


def write_score_artifacts(save_dir: str, ckpt_name: str,
                          scores: Dict[str, float],
                          img_to_eval: Dict[object, Dict[str, float]],
                          valid_ppl: Optional[float] = None) -> None:
    """metric_scores.txt / .csv / _detailed_{n}.json (infer_fn.py:236-290)."""
    os.makedirs(save_dir, exist_ok=True)
    present = [m for m in METRIC_ORDER if m in scores]

    def _append_with_header(path: str, header: str, row: str) -> None:
        # re-emit the header when the metric set changed between appends
        # (a sweep with the METEOR/SPICE jars after one without, or
        # valid_ppl appearing), so no row sits under another's header
        prev = None
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.startswith("checkpoint"):
                        prev = line.rstrip("\n")
        with open(path, "a") as f:
            if prev != header:
                f.write(header + "\n")
            f.write(row + "\n")

    txt = os.path.join(save_dir, "metric_scores.txt")
    _append_with_header(
        txt, "checkpoint\t" + "\t".join(present),
        ckpt_name + "\t" + "\t".join(f"{scores[m]:.6f}" for m in present))

    csv = os.path.join(save_dir, "metric_scores.csv")
    header = ["checkpoint"] + present
    row = [ckpt_name] + [f"{scores[m]:.6f}" for m in present]
    if valid_ppl is not None:
        header.append("valid_ppl")
        row.append(f"{valid_ppl:.6f}")
    _append_with_header(csv, ",".join(header), ",".join(row))

    # per-image detail, sorted by CIDEr ascending (worst first)
    detail = sorted(img_to_eval.values(),
                    key=lambda d: d.get("CIDEr", 0.0))
    n = len([f for f in os.listdir(save_dir)
             if f.startswith("metric_scores_detailed")])
    with open(os.path.join(save_dir, f"metric_scores_detailed_{n}.json"),
              "w") as f:
        json.dump(detail, f, indent=2)


def write_caption_json(path: str, image_ids: Sequence,
                       captions: Sequence[str]) -> None:
    """COCO submission format [{image_id, caption}] (reference
    infer_fn.py:153-175)."""
    out = [{"image_id": _image_id(i), "caption": c}
           for i, c in zip(image_ids, captions)]
    with open(path, "w") as f:
        json.dump(out, f)
