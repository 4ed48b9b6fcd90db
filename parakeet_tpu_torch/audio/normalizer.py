"""Invertible spectrogram-magnitude normalizers (host side, numpy) of the
port: a copy of ``parakeet_tpu/audio/normalizer.py``.

Same interface and math as the reference's spec normalizers
(reference: parakeet/audio/spec_normalizer.py:31-74): ``transform`` maps raw
magnitude into the training domain, ``inverse`` recovers magnitude for
vocoding/Griffin-Lim.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NormalizerBase", "LogMagnitude", "UnitMagnitude"]


class NormalizerBase:
    def transform(self, spec):
        raise NotImplementedError

    def inverse(self, normalized):
        raise NotImplementedError


class LogMagnitude(NormalizerBase):
    """Natural-log magnitude with a floor (WaveFlow / Tacotron2 style)."""

    def __init__(self, min: float = 1e-5):
        self.min = min

    def transform(self, x):
        return np.log(np.maximum(x, self.min))

    def inverse(self, x):
        return np.exp(x)


class UnitMagnitude(NormalizerBase):
    """dB-scaled magnitude mapped into [0, 1]."""

    def __init__(self, min: float = 1e-5):
        self.min = min

    def transform(self, x):
        db = 20 * np.log10(np.maximum(x, self.min)) - 20
        return np.clip((db + 100) / 100, 0, 1)

    def inverse(self, x):
        db = np.clip(x, 0, 1) * 100 - 100
        return np.power(10.0, (db + 20) / 20)
