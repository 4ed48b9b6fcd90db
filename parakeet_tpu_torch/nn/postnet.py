"""Postnet (counterpart of ``parakeet_tpu/nn/postnet.py::Postnet``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import SameConv1d
from .dropout import Dropout

__all__ = ["Postnet"]

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
                bn = getattr(self, f"bn_{i}")
                if deterministic:
                    h = F.batch_norm(h.transpose(1, 2), bn.running_mean,
                                     bn.running_var, bn.weight, bn.bias,
                                     training=False,
                                     eps=bn.eps).transpose(1, 2)
                else:
                    h = _batch_norm_train(bn, h)
            if i < self.n_layers - 1:
                h = torch.tanh(h)
            h = self.dropout(h, deterministic=deterministic, rng=rng)
        return h
