"""Padding with bucketed lengths (counterpart of
``parakeet_tpu/data/batch.py``'s ``bucket_length`` and
``batch_sequences``).

Lengths are padded up to a bucket boundary rather than to the longest
item of the batch, as the JAX package does.  On the card this keeps the
set of shapes a run meets small, which is what a CUDA graph per shape or
a cache of tuned kernels needs; it also makes the port's batches equal
the JAX package's, so the two pipelines compare bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["round_up", "bucket_length", "batch_sequences"]


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_length(max_len: int, bucket_size: int = 32,
                  cap: Optional[int] = None) -> int:
    """Smallest bucket boundary >= max_len (optionally capped)."""
    length = round_up(max(max_len, 1), bucket_size)
    if cap is not None:
        length = min(length, cap)
    return length


def batch_sequences(seqs: Sequence[np.ndarray], axis: int = 0,
                    pad_value: float = 0.0, bucket_size: int = 1,
                    length: Optional[int] = None) -> np.ndarray:
    """Stack variable-length arrays, padding ``axis`` to a common length.

    ``length`` overrides the computed (bucketed) target length; items
    longer than it are truncated.
    """
    seqs = [np.asarray(s) for s in seqs]
    if axis != 0:
        seqs = [np.moveaxis(s, axis, 0) for s in seqs]
    max_len = max(s.shape[0] for s in seqs)
    target = length if length is not None else bucket_length(
        max_len, bucket_size)
    out = np.full((len(seqs), target, *seqs[0].shape[1:]), pad_value,
                  dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        n = min(s.shape[0], target)
        out[i, :n] = s[:n]
    if axis != 0:
        out = np.moveaxis(out, 1, axis + 1)
    return out
