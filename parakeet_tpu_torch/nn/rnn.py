"""flax's ``OptimizedLSTMCell`` and ``GRUCell`` and ``nn.RNN`` over a
padded batch, in PyTorch.

flax's cell has no input-side bias: its four input dense layers
``ii/if/ig/io`` are bias-free and the recurrent ones ``hi/hf/hg/ho`` carry
the biases.  ``LSTMCell`` is ``torch.nn.LSTMCell`` with its ``bias_ih``
parameter replaced by a zero buffer, so PyTorch's fused cell and sequence
kernels run unchanged and the optimizer and the bridge see exactly flax's
parameters (``bridge.py`` maps the eight dense layers onto ``weight_ih``,
``weight_hh`` and ``bias_hh``).  flax's carry is (c, h); the port keeps
torch's (h, c).

flax's ``GRUCell`` has biases on its three input dense layers
``ir/iz/in`` and on the recurrent ``hn`` only (``hr``/``hz`` are
bias-free).  ``GRUCell`` holds exactly those: ``weight_ih``/``weight_hh``
(3H, .) and ``bias_ih`` (3H) in torch's gate order r, z, n, and
``bias_hn`` (H); the recurrent r and z biases are a zero buffer, joined
to ``bias_hn`` for PyTorch's GRU kernels.

``lstm_sequence`` (``gru_sequence``) runs a cell over a whole (B, T, C)
sequence in one ``torch.lstm`` (``torch.gru``) call, and
``flip_sequences`` reverses each sequence inside its own length as
flax's ``nn.RNN(reverse=True, keep_order=True,
seq_lengths=...)`` does: with both, a bidirectional layer computes flax's
values at every position, padded ones included, with no host copy of the
lengths (it may be captured in a CUDA graph).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["LSTMCell", "GRUCell", "lstm_sequence", "gru_sequence",
           "flip_sequences"]


class LSTMCell(nn.LSTMCell):
    """``forward(x, (h, c)) -> (h', c')``; gates i, f, g, o; no input-side
    bias."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, bias=True)
        del self.bias_ih
        self.register_buffer("bias_ih", torch.zeros(4 * hidden_size),
                             persistent=False)

    def zero_state(self, batch: int, like: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch, self.hidden_size), dtype=like.dtype,
                        device=like.device)
        return z, z.clone()


class GRUCell(nn.Module):
    """``forward(x, h) -> h'``; gates r, z, n; flax's biases (see the
    module's doc)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        h = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * h, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * h, h))
        self.bias_ih = nn.Parameter(torch.zeros(3 * h))
        self.bias_hn = nn.Parameter(torch.zeros(h))
        self.register_buffer("bias_hrz", torch.zeros(2 * h),
                             persistent=False)

    @property
    def bias_hh(self) -> torch.Tensor:
        return torch.cat([self.bias_hrz.to(self.bias_hn.dtype),
                          self.bias_hn])

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return torch.gru_cell(x, h, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh)


def gru_sequence(cell: GRUCell, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, H): ``cell`` from the zero state over every
    position of ``x`` (flax's ``nn.RNN`` outputs)."""
    h0 = torch.zeros((1, x.shape[0], cell.hidden_size), dtype=x.dtype,
                     device=x.device)
    out, _ = torch.gru(x, h0, (cell.weight_ih, cell.weight_hh,
                               cell.bias_ih, cell.bias_hh),
                       True, 1, 0.0, torch.is_grad_enabled(), False, True)
    return out


def lstm_sequence(cell: LSTMCell, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, H): ``cell`` from the zero state over every
    position of ``x`` (flax's ``nn.RNN`` outputs, which are not masked
    past a sequence's length).  A width that the cell does not take
    raises: ``torch.lstm`` itself does not check it on the CPU."""
    if x.shape[-1] != cell.weight_ih.shape[1]:
        raise ValueError(f"the LSTM takes {cell.weight_ih.shape[1]} "
                         f"channels, the input has {x.shape[-1]}")
    h0, c0 = cell.zero_state(x.shape[0], x)
    out, _, _ = torch.lstm(
        x, (h0[None], c0[None]),
        (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh),
        True, 1, 0.0, torch.is_grad_enabled(), False, True)
    return out


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row of (B, T, C) inside its length and the padding
    behind it apart: position t takes ``(T - 1 - t + length) % T``, as
    flax's ``flip_sequences``.  It is its own inverse."""
    t = x.shape[1]
    pos = torch.arange(t - 1, -1, -1, device=x.device)
    idx = (pos[None, :] + lengths[:, None].to(pos.dtype)) % t
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
