"""Human-order sort keys (digit runs compare numerically); counterpart of
comic_tpu/utils/natural_sort.py (reference common/natural_sort.py:15-24).
Checkpoint listings sort with it, so model_compact-9 comes before
model_compact-10."""

from __future__ import annotations

import re
from typing import List, Union

_DIGITS = re.compile(r"(\d+)")


def natural_key(s: str) -> List[Union[int, str]]:
    return [int(part) if part.isdigit() else part.lower()
            for part in _DIGITS.split(str(s))]


def natural_sorted(items) -> list:
    return sorted(items, key=natural_key)
