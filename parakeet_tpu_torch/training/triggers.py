"""Trigger predicates for extensions and stopping (a copy of
``parakeet_tpu/training/triggers.py``, which the port cannot import: that
package's ``__init__`` pulls in JAX).

Same semantics as the reference's triggers (reference:
parakeet/training/triggers/{interval_trigger.py:16, limit_trigger.py:16,
time_trigger.py:16, trigger.py:19-27}).
"""
from __future__ import annotations

import time

__all__ = ["IntervalTrigger", "LimitTrigger", "TimeTrigger", "get_trigger",
           "never_fire_trigger"]


class IntervalTrigger:
    """Fires every ``period`` iterations or epochs."""

    def __init__(self, period: int, unit: str = "iteration"):
        if unit not in ("iteration", "epoch"):
            raise ValueError(f"unit should be iteration or epoch, got {unit}")
        if period <= 0:
            raise ValueError("period should be positive")
        self.period = period
        self.unit = unit
        self.last_index = None

    def prime(self, trainer) -> None:
        """Sync to the trainer's current (possibly resumed) state so the
        next __call__ fires only on progress made after this point; the
        Trainer primes all interval triggers before its loop."""
        state = trainer.updater.state
        self.last_index = (state.iteration if self.unit == "iteration"
                           else state.epoch)

    def __call__(self, trainer) -> bool:
        state = trainer.updater.state
        index = state.iteration if self.unit == "iteration" else state.epoch
        if self.last_index is None:
            self.last_index = 0
        fired = index != self.last_index and index % self.period == 0
        self.last_index = index
        return fired


class LimitTrigger:
    """Fires (stops training) once the limit is reached."""

    def __init__(self, limit: int, unit: str = "iteration"):
        if unit not in ("iteration", "epoch"):
            raise ValueError(f"unit should be iteration or epoch, got {unit}")
        if limit <= 0:
            raise ValueError("limit should be positive")
        self.limit = limit
        self.unit = unit

    def __call__(self, trainer) -> bool:
        state = trainer.updater.state
        index = state.iteration if self.unit == "iteration" else state.epoch
        return index >= self.limit


class TimeTrigger:
    """Fires every ``period`` seconds of wall clock."""

    def __init__(self, period: float):
        self.period = period
        self._next = time.time() + period

    def __call__(self, trainer) -> bool:
        now = time.time()
        if now >= self._next:
            self._next += self.period
            return True
        return False


def never_fire_trigger(trainer) -> bool:
    return False


def get_trigger(trigger):
    """Coerce (period, unit) tuples / None / callables to a trigger."""
    if trigger is None:
        return never_fire_trigger
    if callable(trigger):
        return trigger
    period, unit = trigger
    return IntervalTrigger(period, unit)
