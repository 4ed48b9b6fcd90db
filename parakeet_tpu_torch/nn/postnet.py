"""Postnet (counterpart of ``parakeet_tpu/nn/postnet.py::Postnet``),
inference only."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import SameConv1d

__all__ = ["Postnet"]

_BN_EPS = 1e-5          # flax BatchNorm's default epsilon


class Postnet(nn.Module):
    """Residual refinement: conv1d (+BN) + tanh, no tanh on the last layer;
    (B, T, odim) -> (B, T, odim).

    BatchNorm always uses its running statistics (the flax
    ``batch_stats`` ``mean`` / ``var``), since the port has no training
    path yet; with BatchNorm on, the convolutions have no bias.
    """

    def __init__(self, odim: int, n_layers: int = 5, n_chans: int = 512,
                 n_filts: int = 5, use_batch_norm: bool = True):
        super().__init__()
        self.n_layers = n_layers
        self.use_batch_norm = use_batch_norm
        for i in range(n_layers):
            cin = odim if i == 0 else n_chans
            cout = odim if i == n_layers - 1 else n_chans
            self.add_module(f"conv_{i}", SameConv1d(
                cin, cout, n_filts, bias=not use_batch_norm))
            if use_batch_norm:
                self.add_module(f"bn_{i}", nn.BatchNorm1d(cout, eps=_BN_EPS))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        h = xs
        for i in range(self.n_layers):
            h = getattr(self, f"conv_{i}")(h)
            if self.use_batch_norm:
                bn = getattr(self, f"bn_{i}")
                h = F.batch_norm(h.transpose(1, 2), bn.running_mean,
                                 bn.running_var, bn.weight, bn.bias,
                                 training=False, eps=bn.eps).transpose(1, 2)
            if i < self.n_layers - 1:
                h = torch.tanh(h)
        return h
