"""Feature-last 1-D convolutions (counterpart of
``parakeet_tpu/nn/conv.py``; reference: parakeet/modules/conv.py:23-260).

``SameConv1d`` is flax's ``nn.Conv(features, (k,), kernel_dilation=(d,),
padding="SAME")`` that the JAX modules use.  ``Conv1dCell`` is a causal
dilated convolution that runs over a whole sequence at once or as a cell,
one frame a step, with the last ``receptive_field - 1`` input frames as
its state, which the caller carries (nothing is kept on the module).
``Conv1dBatchNorm`` is a convolution and flax's BatchNorm; ``GLU`` the
gated linear unit.  Submodules keep the flax names (``conv``, ``bn``).
Each takes flax's ``dtype`` (``nn/precision.py``): the convolution's
operands, weight and bias in ``dtype``, BatchNorm in float32 and its
result in the convolution's dtype; ``None`` computes in the parameters'
dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .batch_norm import flax_batch_norm
from .precision import cast_product

__all__ = ["Conv1d", "SameConv1d", "Conv1dCell", "Conv1dBatchNorm", "GLU"]


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` (B, Cin, T) -> (B, Cout, T - (k - 1) d), VALID, with
    flax's ``dtype``: the product in ``dtype``, then ``+ bias`` in
    ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias,
                         dilation=dilation)
        self.dtype = dtype

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.dtype is None or self.dtype == w.dtype:
            return F.conv1d(h.to(w.dtype), w, self.bias,
                            dilation=self.dilation)
        y = cast_product(lambda a, b: F.conv1d(a, b, dilation=self.dilation),
                         self.dtype, h, w)
        return y if self.bias is None else (
            y + self.bias.to(self.dtype)[:, None])


class SameConv1d(Conv1d):
    """(B, T, Cin) -> (B, T, Cout) with flax SAME zero padding: (k - 1) d
    frames in all, ((k - 1) d) // 2 on the left and the rest on the right
    (for k 4 at d 1: 1 and 2).  The weight keeps PyTorch's (Cout, Cin, k)
    layout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = (self.kernel_size[0] - 1) * self.dilation[0]
        h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return super().forward(h).transpose(1, 2)


class Conv1dCell(nn.Module):
    """Causal dilated Conv1D, (B, T, Cin) -> (B, T, Cout).

    ``forward`` convolves a whole (teacher-forced) sequence with
    ``receptive_field - 1`` zero frames on the left; ``initial_state``
    and ``step`` run the same weights one frame at a time, the state being
    the last ``receptive_field - 1`` input frames, and a step gives what
    ``forward`` gives at that frame."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, dilation: int = 1,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = in_features
        self.conv = Conv1d(in_features, features, kernel_size,
                           dilation=dilation, bias=use_bias, dtype=dtype)

    @property
    def receptive_field(self) -> int:
        return 1 + (self.conv.kernel_size[0] - 1) * self.conv.dilation[0]

    def _valid(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._valid(F.pad(x, (0, 0, self.receptive_field - 1, 0)))

    def initial_state(self, batch: int, device=None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Zero history (B, receptive_field - 1, Cin)."""
        return torch.zeros((batch, self.receptive_field - 1,
                            self.in_features), device=device,
                           dtype=dtype or self.conv.dtype
                           or self.conv.weight.dtype)

    def step(self, state: torch.Tensor, x_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step: state (B, rf - 1, Cin), x_t (B, Cin) -> (new state,
        y_t (B, Cout))."""
        window = torch.cat([state, x_t[:, None]], dim=1)
        return window[:, 1:], self._valid(window)[:, -1]


class Conv1dBatchNorm(nn.Module):
    """Conv1D then BatchNorm, feature-last.  ``padding`` is flax's "SAME"
    or "VALID"; ``momentum`` is flax's (the running statistics keep
    ``momentum`` of their value a step), stored as PyTorch's ``1 -
    momentum`` on ``bn``.  ``forward(x, train=False)``: with ``train`` the
    batch's statistics, updated into the running ones as flax does."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, padding: str = "SAME",
                 use_bias: bool = False, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
        self.padding = padding
        self.conv = (SameConv1d if padding == "SAME" else Conv1d)(
            in_features, features, kernel_size, bias=use_bias, dtype=dtype)
        self.bn = nn.BatchNorm1d(features, eps=epsilon, momentum=1 - momentum)

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        if self.padding == "SAME":
            y = self.conv(x)
        else:
            y = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return flax_batch_norm(self.bn, y, deterministic=not train,
                               momentum=1 - self.bn.momentum)


class GLU(nn.Module):
    """Gated linear unit over ``axis``: a * sigmoid(b) of its two
    halves."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(x, dim=self.axis)
