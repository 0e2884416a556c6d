"""Learning-rate and teacher-forcing schedules.

Port of the JAX package's ``training/schedule.py``: the learning rate
decays by ``learning_rate_decay`` first at ``learning_rate_decay_start``
optimizer steps and then every ``learning_rate_decay_each`` steps.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def step_decay_schedule(hp, lr0: Optional[float] = None
                        ) -> Callable[[int], float]:
    """step -> learning rate, starting at ``lr0`` (``hp.learning_rate`` by
    default).  With ``lr0=1`` it is the factor ``LambdaLR`` takes."""
    lr0 = hp.learning_rate if lr0 is None else lr0
    gamma = hp.learning_rate_decay
    start = hp.learning_rate_decay_start
    each = max(hp.learning_rate_decay_each, 1)

    def schedule(step: int) -> float:
        n = 0 if step < start else 1 + (step - start) // each
        return lr0 * gamma ** n

    return schedule


def cos_decay(global_step: int, decay_steps: int) -> float:
    """Cosine decay from 1 to 0 over ``decay_steps``."""
    global_step = min(global_step, decay_steps)
    return 0.5 * (1 + math.cos(math.pi * global_step / decay_steps))


def teacher_forcing_ratio(hp, global_step: int) -> float:
    """A constant ratio, or a cosine decay after a warm-up."""
    if hp.constant_teacher_forcing:
        return hp.teacher_forcing
    return cos_decay(
        max(global_step - hp.teacher_forcing_start_steps, 0),
        hp.teacher_forcing_steps)
