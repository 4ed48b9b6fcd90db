"""Masking primitives (counterpart of ``parakeet_tpu/ops/masking.py``).

``sequence_mask`` is True at *valid* positions and takes an explicit
``maxlen`` so that shapes stay static, as in the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["sequence_mask"]


def sequence_mask(lengths: torch.Tensor, maxlen: int,
                  dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """(...,) lengths -> (..., maxlen) mask, True where index < length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos < lengths[..., None]).to(dtype)
