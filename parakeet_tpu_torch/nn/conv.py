"""Feature-last 1-D convolution, the counterpart of flax's
``nn.Conv(features, (k,), padding="SAME")`` that the JAX modules use."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SameConv1d"]


class SameConv1d(nn.Conv1d):
    """(B, T, Cin) -> (B, T, Cout) with flax SAME zero padding:
    (k - 1) // 2 frames on the left and k // 2 on the right.  The weight
    keeps PyTorch's (Cout, Cin, k) layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        h = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        return F.conv1d(h, self.weight, self.bias).transpose(1, 2)
