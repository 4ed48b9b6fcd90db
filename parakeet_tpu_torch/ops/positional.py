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
                               device: Optional[torch.device] = None,
                               in_dtype: bool = False) -> torch.Tensor:
    """(num_positions, feature_size) table with
    ``pe[p, 2i] = sin((start_pos + p) / 10000^(2i / D))`` and cos on the
    odd channels.

    The table is computed in float32 and cast to ``dtype``; with
    ``in_dtype`` it is computed in ``dtype`` op by op, as the JAX version
    is (what a flax module at ``dtype=bfloat16`` adds: in bf16 the
    positions from 256 on, 1e4 (9984) and every angle are rounded).  The
    two agree for float32.  Every operand is made on ``device``
    (``torch.full``, not ``torch.tensor``), so the call copies nothing
    from the host and may be captured in a CUDA graph.
    """
    ct = dtype if in_dtype else torch.float32
    channel = torch.arange(0, feature_size, 2, dtype=ct, device=device)
    index = torch.arange(num_positions, dtype=ct, device=device) + start_pos
    denom = torch.pow(torch.full((), 1e4, dtype=ct, device=device),
                      channel / feature_size)
    angle = index[:, None] / denom[None, :]
    pe = torch.zeros((num_positions, feature_size), dtype=ct, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, :feature_size // 2])
    return pe.to(dtype)
