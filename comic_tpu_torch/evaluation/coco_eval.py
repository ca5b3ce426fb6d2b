"""Caption JSON writer (the port's own copy of
comic_tpu.evaluation.coco_eval.write_caption_json). Metric scoring waits
for a later slice of the port."""

from __future__ import annotations

import json
from typing import Sequence


def _image_id(value):
    """COCO ids are ints; insta-style ids are arbitrary strings — coerce
    only when numeric so both sides key identically."""
    if isinstance(value, int):
        return value
    s = str(value)
    return int(s) if s.lstrip("-").isdigit() else s


def write_caption_json(path: str, image_ids: Sequence,
                       captions: Sequence[str]) -> None:
    """COCO submission format [{image_id, caption}] (reference
    infer_fn.py:153-175)."""
    out = [{"image_id": _image_id(i), "caption": c}
           for i, c in zip(image_ids, captions)]
    with open(path, "w") as f:
        json.dump(out, f)
