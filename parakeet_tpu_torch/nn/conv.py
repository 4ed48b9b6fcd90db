"""Feature-last 1-D convolution, the counterpart of flax's
``nn.Conv(features, (k,), kernel_dilation=(d,), padding="SAME")`` that
the JAX modules use."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SameConv1d"]


class SameConv1d(nn.Conv1d):
    """(B, T, Cin) -> (B, T, Cout) with flax SAME zero padding: (k - 1) d
    frames in all, ((k - 1) d) // 2 on the left and the rest on the right
    (for k 4 at d 1: 1 and 2).  The weight keeps PyTorch's (Cout, Cin, k)
    layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias,
                         dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = (self.kernel_size[0] - 1) * self.dilation[0]
        h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return F.conv1d(h, self.weight, self.bias,
                        dilation=self.dilation).transpose(1, 2)
