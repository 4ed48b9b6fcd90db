"""flax's ``OptimizedLSTMCell`` and ``nn.RNN`` over a padded batch, in
PyTorch.

flax's cell has no input-side bias: its four input dense layers
``ii/if/ig/io`` are bias-free and the recurrent ones ``hi/hf/hg/ho`` carry
the biases.  ``LSTMCell`` is ``torch.nn.LSTMCell`` with its ``bias_ih``
parameter replaced by a zero buffer, so PyTorch's fused cell and sequence
kernels run unchanged and the optimizer and the bridge see exactly flax's
parameters (``bridge.py`` maps the eight dense layers onto ``weight_ih``,
``weight_hh`` and ``bias_hh``).  flax's carry is (c, h); the port keeps
torch's (h, c).

``lstm_sequence`` runs a cell over a whole (B, T, C) sequence in one
``torch.lstm`` call, and ``flip_sequences`` reverses each sequence inside
its own length as flax's ``nn.RNN(reverse=True, keep_order=True,
seq_lengths=...)`` does: with both, a bidirectional layer computes flax's
values at every position, padded ones included, with no host copy of the
lengths (it may be captured in a CUDA graph).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["LSTMCell", "lstm_sequence", "flip_sequences"]


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


def lstm_sequence(cell: LSTMCell, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, H): ``cell`` from the zero state over every
    position of ``x`` (flax's ``nn.RNN`` outputs, which are not masked
    past a sequence's length)."""
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
