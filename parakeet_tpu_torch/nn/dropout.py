"""Dropout with flax's semantics on an explicit ``torch.Generator``.

``torch.nn.Dropout`` and ``F.dropout`` draw from the global generator and
take none of their own; the port's training steps draw every random
number from the state's generator instead, so the keep-mask here comes
from ``torch.rand(..., generator=rng)``.  As ``flax.linen.Dropout``: keep
each element with probability 1 - rate and scale it by 1 / (1 - rate);
nothing happens (and nothing is drawn) when deterministic or at rate 0;
rate 1 drops everything.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """``forward(x, deterministic=..., rng=...)``; ``rng`` (on x's
    device) is needed whenever the call drops anything."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1]")
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, *, deterministic: bool,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if rng is None:
            raise ValueError(f"dropout at rate {self.rate} needs a "
                             "torch.Generator (rng=) when not deterministic")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
