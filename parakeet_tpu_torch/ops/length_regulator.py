"""Length regulation: duration -> frame expansion (counterpart of
``parakeet_tpu/ops/length_regulator.py::length_regulate``).

Frame t belongs to the token i with cumsum(d)[i-1] <= t < cumsum(d)[i];
the output has a static ``max_len`` frames and is zero past the total.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["length_regulate"]


def length_regulate(encodings: torch.Tensor, durations: torch.Tensor,
                    max_len: int, alpha: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, L, D) token encodings by (B, L) integer durations.

    ``alpha`` scales the durations, which are then rounded (half to
    even).  Returns frames (B, max_len, D), zero past each row's total,
    and the totals (B,) as int32.
    """
    if alpha != 1.0:
        durations = torch.round(durations.to(torch.float32) * alpha)
    durations = durations.to(torch.int32)
    cum = torch.cumsum(durations, dim=-1, dtype=torch.int32)      # (B, L)
    total = cum[:, -1]
    t = torch.arange(max_len, dtype=torch.int32,
                     device=encodings.device)                     # (T,)
    # token index of each frame: the first i with cum[i] > t
    token_idx = (t[None, :, None] >= cum[:, None, :]).sum(-1)     # (B, T)
    token_idx = token_idx.clamp(0, encodings.shape[1] - 1)
    frames = torch.gather(
        encodings, 1,
        token_idx[..., None].expand(-1, -1, encodings.shape[-1]))
    valid = t[None, :] < total[:, None]
    return frames * valid[..., None].to(frames.dtype), total
