"""Tensor reorganization helpers (counterpart of
``parakeet_tpu/ops/geometry.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["time_shift"]


def time_shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """(B, T, C) -> y with y[:, t] = x[:, t + off], zero outside [0, T)
    (the shifted view behind the shifted-matmul convolutions)."""
    if off == 0:
        return x
    t = x.shape[1]
    if off > 0:
        return F.pad(x, (0, 0, 0, off))[:, off:]
    return F.pad(x, (0, 0, -off, 0))[:, :t]
