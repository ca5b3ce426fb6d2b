"""Learning-rate schedules; counterpart of comic_tpu/training/schedule.py.

- Cosine: lr_end + (lr_start - lr_end) * (1 + cos(min(1, t/T) * pi)) / 2,
  the schedule the reference builds (model_base.py:809-820), as a float
  cosine (the reference's py2 graph floors t/T; comic_tpu documents why it
  does not).
- Legacy: constant LR halved every ``lr_reduce_every_n_epochs`` epochs,
  never below lr_end (model_base.py:792-806, train_fn.py:310-317).

A schedule maps a step (a host int) to a float, computed in float32 as
comic_tpu computes it, so the optimizer takes its rate without a device
round trip.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

_F = np.float32


def cosine_schedule(lr_start: float, lr_end: float, max_step: int
                    ) -> Callable[[int], float]:
    def fn(step: int) -> float:
        frac = np.minimum(_F(1.0), _F(step) / _F(max(max_step, 1)))
        cos_term = _F(1.0) + np.cos(frac * _F(math.pi))
        return float(_F(lr_start - lr_end) * cos_term / _F(2.0) + _F(lr_end))

    return fn


def legacy_halving_schedule(lr_start: float, steps_per_epoch: int,
                            reduce_every_n_epochs: int, lr_end: float = 0.0
                            ) -> Callable[[int], float]:
    def fn(step: int) -> float:
        epoch = int(step) // max(steps_per_epoch, 1)
        n_halvings = epoch // max(reduce_every_n_epochs, 1)
        lr = _F(lr_start) * np.power(_F(0.5), _F(n_halvings))
        return float(np.maximum(lr, _F(lr_end)))

    return fn
