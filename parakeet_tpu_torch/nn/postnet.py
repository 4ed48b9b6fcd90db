"""Postnet and Prenet (counterparts of ``parakeet_tpu/nn/postnet.py``),
and flax's BatchNorm on feature-last tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import SameConv1d
from .dropout import Dropout

__all__ = ["Postnet", "Prenet", "flax_batch_norm"]

_BN_EPS = 1e-5          # flax BatchNorm's default epsilon
_BN_MOMENTUM = 0.99     # flax BatchNorm's default momentum


def _batch_norm_train(bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` on (B, T, C): normalize
    with the batch's mean and *biased* variance over (B, T), computed in
    float32 as E[x^2] - E[x]^2 clipped at 0, and update the running
    statistics in place as flax does, ``ra = 0.99 ra + 0.01 batch``.
    ``torch.nn.BatchNorm1d``'s own update would use the unbiased variance
    and the other momentum convention, so only its tensors are used."""
    x = h.float()
    mean = x.mean(dim=(0, 1))
    var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean
                              + (1 - _BN_MOMENTUM) * mean)
        bn.running_var.copy_(_BN_MOMENTUM * bn.running_var
                             + (1 - _BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean) * mul + bn.bias).to(h.dtype)


def flax_batch_norm(bn: nn.BatchNorm1d, h: torch.Tensor, *,
                    deterministic: bool) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=deterministic)`` over the last
    axis of (B, T, C): the running statistics when deterministic, else
    ``_batch_norm_train``."""
    if not deterministic:
        return _batch_norm_train(bn, h)
    return F.batch_norm(h.transpose(1, 2), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, training=False,
                        eps=bn.eps).transpose(1, 2)


class Postnet(nn.Module):
    """Residual refinement: conv1d (+BN) + tanh, no tanh on the last layer,
    then dropout; (B, T, odim) -> (B, T, odim).

    As in flax, ``deterministic`` (default True) selects BatchNorm's
    running statistics (the flax ``batch_stats`` ``mean`` / ``var``) and no
    dropout; with ``deterministic=False`` BatchNorm uses the batch's
    statistics and updates the running ones, and dropout draws from
    ``rng``.  With BatchNorm on, the convolutions have no bias.
    """

    def __init__(self, odim: int, n_layers: int = 5, n_chans: int = 512,
                 n_filts: int = 5, use_batch_norm: bool = True,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.n_layers = n_layers
        self.use_batch_norm = use_batch_norm
        self.dropout = Dropout(dropout_rate)
        for i in range(n_layers):
            cin = odim if i == 0 else n_chans
            cout = odim if i == n_layers - 1 else n_chans
            self.add_module(f"conv_{i}", SameConv1d(
                cin, cout, n_filts, bias=not use_batch_norm))
            if use_batch_norm:
                self.add_module(f"bn_{i}", nn.BatchNorm1d(cout, eps=_BN_EPS))

    def forward(self, xs: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        h = xs
        for i in range(self.n_layers):
            h = getattr(self, f"conv_{i}")(h)
            if self.use_batch_norm:
                h = flax_batch_norm(getattr(self, f"bn_{i}"), h,
                                    deterministic=deterministic)
            if i < self.n_layers - 1:
                h = torch.tanh(h)
            h = self.dropout(h, deterministic=deterministic, rng=rng)
        return h


class Prenet(nn.Module):
    """Bottleneck MLP: ``n_layers`` x (linear -> ReLU -> dropout).

    With ``always_dropout`` (Tacotron2's decoder prenet) the dropout stays
    on whatever ``deterministic`` says, at inference too.  ``keep``, the
    stacked masks of ``keep_masks`` (n_layers, *x.shape[:-1], n_units),
    replaces the draws, so that a decode loop may draw every step's masks
    before the loop; without it each layer draws from ``rng``.
    """

    def __init__(self, in_units: int, n_layers: int = 2, n_units: int = 256,
                 dropout_rate: float = 0.5, always_dropout: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.n_layers, self.n_units = n_layers, n_units
        self.always_dropout = always_dropout
        self.dropout = Dropout(dropout_rate)
        for i in range(n_layers):
            self.add_module(f"fc_{i}", nn.Linear(
                in_units if i == 0 else n_units, n_units, bias=use_bias))

    def drops(self, deterministic: bool) -> bool:
        """Whether a call with ``deterministic`` drops anything."""
        return ((self.always_dropout or not deterministic)
                and self.dropout.rate > 0.0)

    def keep_masks(self, shape, rng: torch.Generator,
                   device) -> torch.Tensor:
        """Keep-masks (n_layers, *shape, n_units) for inputs of leading
        shape ``shape``, drawn from ``rng``."""
        return self.dropout.keep_mask(
            (self.n_layers, *shape, self.n_units), rng, device)

    def forward(self, xs: torch.Tensor, *, deterministic: bool = True,
                rng=None, keep=None) -> torch.Tensor:
        drop = self.drops(deterministic)
        h = xs
        for i in range(self.n_layers):
            h = torch.relu(getattr(self, f"fc_{i}")(h))
            if drop and keep is not None:
                h = self.dropout.apply_keep(h, keep[i])
            elif drop:
                h = self.dropout(h, deterministic=False, rng=rng)
        return h
