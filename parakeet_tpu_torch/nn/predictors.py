"""Variance predictors (counterpart of ``parakeet_tpu/nn/predictors.py``),
(B, T, C) layout, and the duration predictor's loss.

PyTorch needs each layer's input width up front, so the constructors take
``idim`` where flax infers it.  Dropout follows flax: ``deterministic``
(default True) and, when False, the generator ``rng`` it draws from.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import SameConv1d
from .dropout import Dropout

__all__ = ["DurationPredictor", "VariancePredictor", "VarianceEmbedding",
           "duration_predictor_loss"]

_LN_EPS = 1e-6          # flax LayerNorm's default epsilon


class _ConvStack(nn.Module):
    """(conv1d -> relu -> LayerNorm -> dropout) x n, then a linear map to
    1."""

    def __init__(self, idim: int, n_layers: int, n_chans: int,
                 kernel_size: int, dropout_rate: float):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", SameConv1d(
                idim if i == 0 else n_chans, n_chans, kernel_size))
            self.add_module(f"norm_{i}", nn.LayerNorm(n_chans, eps=_LN_EPS))
        self.dropout = Dropout(dropout_rate)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, *, deterministic: bool = True, rng=None):
        h = xs
        for i in range(self.n_layers):
            h = F.relu(getattr(self, f"conv_{i}")(h))
            h = getattr(self, f"norm_{i}")(h)
            h = self.dropout(h, deterministic=deterministic, rng=rng)
        return self.linear(h)[..., 0]


class DurationPredictor(nn.Module):
    """Log-durations, or with ``inference=True`` integer durations
    ``clip(round(exp(x) - offset), 0)`` (round half to even, as jnp.round).
    Padded tokens (``pad_mask`` True) get 0."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.1,
                 offset: float = 1.0):
        super().__init__()
        self.offset = offset
        self.stack = _ConvStack(idim, n_layers, n_chans, kernel_size,
                                dropout_rate)

    def forward(self, xs, pad_mask=None, inference: bool = False, *,
                deterministic: bool = True, rng=None):
        out = self.stack(xs, deterministic=deterministic, rng=rng)
        if inference:
            out = torch.clamp(torch.round(torch.exp(out) - self.offset),
                              min=0)
        if pad_mask is not None:
            out = out.masked_fill(pad_mask, 0.0)
        return out


class VariancePredictor(nn.Module):
    """Pitch / energy predictor; returns (B, T, 1), 0 where ``pad_mask``."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.stack = _ConvStack(idim, n_layers, n_chans, kernel_size,
                                dropout_rate)

    def forward(self, xs, pad_mask=None, *, deterministic: bool = True,
                rng=None):
        out = self.stack(xs, deterministic=deterministic, rng=rng)[..., None]
        if pad_mask is not None:
            out = out.masked_fill(pad_mask, 0.0)
        return out


class VarianceEmbedding(nn.Module):
    """conv1d + dropout embedding of a scalar track (B, T, 1) ->
    (B, T, out_dim)."""

    def __init__(self, out_dim: int, kernel_size: int = 9,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.conv = SameConv1d(1, out_dim, kernel_size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, xs, *, deterministic: bool = True, rng=None):
        return self.dropout(self.conv(xs), deterministic=deterministic,
                            rng=rng)


def duration_predictor_loss(pred_log_durations, target_durations, mask=None,
                            offset: float = 1.0):
    """MSE in the log domain against log(durations + offset), float32;
    masked positions (``mask`` False) are left out of the mean."""
    target = torch.log(target_durations.float() + offset)
    sq = torch.square(pred_log_durations - target)
    if mask is None:
        return sq.mean()
    mask = mask.to(sq.dtype)
    return (sq * mask).sum() / torch.clamp(mask.sum(), min=1.0)
