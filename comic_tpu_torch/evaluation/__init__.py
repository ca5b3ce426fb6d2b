"""Caption JSON output and the SCST reward scorers."""

from .bleu import BleuScorer, bleu
from .cider import Cider, CiderD
from .coco_eval import write_caption_json
from .ngrams import build_idf_cache, load_idf_cache, save_idf_cache
from .scorers import CaptionScorer

__all__ = [
    "BleuScorer", "bleu", "Cider", "CiderD", "write_caption_json",
    "build_idf_cache", "load_idf_cache", "save_idf_cache", "CaptionScorer",
]
