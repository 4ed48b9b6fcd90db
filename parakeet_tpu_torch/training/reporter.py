"""Observation reporting (a copy of ``parakeet_tpu/training/reporter.py``,
which the port cannot import: that package's ``__init__`` pulls in JAX).

Same contract as the reference's reporter (reference:
parakeet/training/reporter.py:22-158): a scoped observation dict that
``report(name, value)`` writes into, plus online scalar summaries used by
evaluators.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

__all__ = ["scope", "report", "get_observations", "Summary", "DictSummary"]

_OBSERVATIONS: Optional[dict] = None


def get_observations() -> Optional[dict]:
    return _OBSERVATIONS


@contextlib.contextmanager
def scope(observations: dict):
    """Route ``report`` calls into ``observations`` within this context."""
    global _OBSERVATIONS
    old = _OBSERVATIONS
    _OBSERVATIONS = observations
    try:
        yield
    finally:
        _OBSERVATIONS = old


def report(name: str, value) -> None:
    """Record a value into the active observation scope (no-op outside)."""
    if _OBSERVATIONS is not None:
        _OBSERVATIONS[name] = value


class Summary:
    """Online mean / std of a scalar stream."""

    def __init__(self):
        self._n = 0
        self._x = 0.0
        self._x2 = 0.0

    def add(self, value) -> None:
        value = float(value)
        self._n += 1
        self._x += value
        self._x2 += value * value

    def compute_mean(self) -> float:
        if self._n == 0:
            raise ValueError("no observations")
        return self._x / self._n

    def make_statistics(self):
        mean = self.compute_mean()
        var = self._x2 / self._n - mean * mean
        return mean, math.sqrt(max(var, 0.0))


class DictSummary:
    """Summaries keyed by observation name."""

    def __init__(self):
        self._summaries: Dict[str, Summary] = {}

    def add(self, observation: dict) -> None:
        for name, value in observation.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            self._summaries.setdefault(name, Summary()).add(value)

    def compute_mean(self) -> Dict[str, float]:
        return {k: s.compute_mean() for k, s in self._summaries.items()}
