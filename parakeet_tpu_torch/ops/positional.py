"""Sinusoidal positional encodings (counterpart of
``parakeet_tpu/ops/positional.py``): even channels sin, odd channels cos,
geometric frequency ladder over 1e4."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sinusoid_position_encoding"]


def sinusoid_position_encoding(num_positions: int, feature_size: int,
                               start_pos: int = 0,
                               dtype: torch.dtype = torch.float32,
                               device: Optional[torch.device] = None
                               ) -> torch.Tensor:
    """(num_positions, feature_size) table with
    ``pe[p, 2i] = sin((start_pos + p) / 10000^(2i / D))`` and cos on the
    odd channels.

    The table is computed in float32 and cast to ``dtype`` (the JAX
    version computes in ``dtype``; the two agree for float32).  Every
    operand is made on ``device`` (``torch.full``, not ``torch.tensor``),
    so the call copies nothing from the host and may be captured in a
    CUDA graph.
    """
    f32 = torch.float32
    channel = torch.arange(0, feature_size, 2, dtype=f32, device=device)
    index = torch.arange(num_positions, dtype=f32, device=device) + start_pos
    denom = torch.pow(torch.full((), 1e4, dtype=f32, device=device),
                      channel / feature_size)
    angle = index[:, None] / denom[None, :]
    pe = torch.zeros((num_positions, feature_size), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, :feature_size // 2])
    return pe.to(dtype)
