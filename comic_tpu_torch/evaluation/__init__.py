"""Caption scoring (COCO evaluation and the SCST reward scorers)."""

from .bleu import BleuScorer, bleu
from .cider import Cider, CiderD
from .coco_eval import (
    CocoCaptionEvaluator,
    evaluate_captions,
    write_caption_json,
    write_score_artifacts,
)
from .ngrams import build_idf_cache, load_idf_cache, save_idf_cache
from .rouge import RougeScorer, rouge_l
from .scorers import CaptionScorer
from .tokenizer import PTBTokenizer

__all__ = [
    "BleuScorer", "bleu", "Cider", "CiderD", "CocoCaptionEvaluator",
    "evaluate_captions", "write_caption_json", "write_score_artifacts",
    "build_idf_cache", "load_idf_cache", "save_idf_cache", "RougeScorer",
    "rouge_l", "CaptionScorer", "PTBTokenizer",
]
