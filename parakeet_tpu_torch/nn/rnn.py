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

Each stacked tensor carries its gate count as ``_flax_leaves``: flax
keeps one leaf a gate, and an optimizer that works leaf by leaf
(``optax.lamb``'s trust ratio, ``training/optimizer.py::Lamb``) takes
its rows in that many equal blocks.

``lstm_sequence`` (``gru_sequence``) runs a cell over a whole (B, T, C)
sequence, without a ``dtype`` in one ``torch.lstm`` (``torch.gru``)
call, and
``flip_sequences`` reverses each sequence inside its own length as
flax's ``nn.RNN(reverse=True, keep_order=True,
seq_lengths=...)`` does: with both, a bidirectional layer computes flax's
values at every position, padded ones included, with no host copy of the
lengths (it may be captured in a CUDA graph).

Both cells take flax's ``dtype`` (``nn/precision.py``).  With
``torch.bfloat16`` a step is flax's cell: the input and recurrent
products (and their biases) in bf16, the gates in bf16
(``precision.sigmoid``) and the carry in whatever dtype the caller keeps
it (flax's ``nn.RNN`` keeps a float32 carry; Tacotron2's decoder its own
bf16 one), so that the state update follows the carry's promotion.
``lstm_sequence`` and ``gru_sequence`` then run flax's scan: every
step's input products in one GEMM, the steps one by one from a float32
carry, the weights rounded once for the whole scan (``cast_once``).
Without a ``dtype`` they run the fused kernel (cuDNN on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .precision import cast, cast_once, dense, sigmoid

__all__ = ["LSTMCell", "GRUCell", "lstm_sequence", "gru_sequence",
           "flip_sequences"]


def _tag_gates(gates: int, *params: nn.Parameter) -> None:
    for p in params:
        p._flax_leaves = gates


class LSTMCell(nn.LSTMCell):
    """``forward(x, (h, c)) -> (h', c')``; gates i, f, g, o; no input-side
    bias."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(input_size, hidden_size, bias=True)
        del self.bias_ih
        self.register_buffer("bias_ih", torch.zeros(4 * hidden_size),
                             persistent=False)
        _tag_gates(4, self.weight_ih, self.weight_hh, self.bias_hh)
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.dtype is None:
            return super().forward(x, state)
        return self.step(self.input_gates(x), state)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """The input side of the gates, x W_ih^T (..., 4H), in the compute
        dtype: what a step needs of its input, for a caller that projects
        every step's input at once."""
        return dense(x, self.weight_ih, None, self.dtype)

    def step(self, gates_in: torch.Tensor,
             state: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """flax's ``OptimizedLSTMCell`` at ``dtype`` from the input side of
        the gates (``input_gates``): (h', c')."""
        h, c = state
        gates = gates_in + dense(h, self.weight_hh, self.bias_hh, self.dtype)
        # one sigmoid over all four gates (g's share unused): elementwise,
        # so each of i, f, o is what its own sigmoid gives, in a third of
        # the launches
        i, f, _, o = sigmoid(gates).chunk(4, dim=-1)
        g = torch.tanh(gates[..., 2 * self.hidden_size:3 * self.hidden_size])
        c = f * c + i * g
        return o * torch.tanh(c), c

    def zero_state(self, batch: int, like: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch, self.hidden_size), dtype=like.dtype,
                        device=like.device)
        return z, z.clone()


class GRUCell(nn.Module):
    """``forward(x, h) -> h'``; gates r, z, n; flax's biases (see the
    module's doc)."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.dtype = dtype
        h = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * h, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * h, h))
        self.bias_ih = nn.Parameter(torch.zeros(3 * h))
        self.bias_hn = nn.Parameter(torch.zeros(h))
        _tag_gates(3, self.weight_ih, self.weight_hh, self.bias_ih)
        self.register_buffer("bias_hrz", torch.zeros(2 * h),
                             persistent=False)

    @property
    def bias_hh(self) -> torch.Tensor:
        return torch.cat([self.bias_hrz.to(self.bias_hn.dtype),
                          self.bias_hn])

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return torch.gru_cell(x, h.to(x.dtype), *_flat_weights(self))
        return self.step(self.input_gates(x), h)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """flax's ``ir/iz/in`` layers at once, with their biases: (..., 3H)
        in the compute dtype."""
        return dense(x, self.weight_ih, self.bias_ih, self.dtype)

    def step(self, gates_in: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """flax's ``GRUCell`` at ``dtype`` from the input side of the
        gates (``input_gates``): h'."""
        gh = dense(h, self.weight_hh, None, self.dtype)
        two = 2 * self.hidden_size
        r, z = sigmoid(gates_in[..., :two] + gh[..., :two]).chunk(2, dim=-1)
        hn = gh[..., two:] + cast(self.bias_hn, gh.dtype)
        n = torch.tanh(gates_in[..., two:] + r * hn)
        return (1.0 - z) * n + z * h


def _flat_weights(cell: nn.Module):
    """The cell's weights as the fused kernels take them."""
    return (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)


def _scan(cell: nn.Module, x: torch.Tensor, state):
    """flax's ``nn.RNN`` scan of ``cell`` (at its ``dtype``) from
    ``state`` over (B, T, C): the outputs, (B, T, H)."""
    gates_in = cell.input_gates(x)
    outs = []
    with cast_once():
        for t in range(x.shape[1]):
            state = cell.step(gates_in[:, t], state)
            outs.append(state[0] if isinstance(state, tuple) else state)
    return torch.stack(outs, dim=1)


def gru_sequence(cell: GRUCell, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, H): ``cell`` from the zero state over every
    position of ``x`` (flax's ``nn.RNN`` outputs)."""
    w = cell.weight_ih
    h0 = torch.zeros((x.shape[0], cell.hidden_size), dtype=w.dtype,
                     device=w.device)
    if cell.dtype is not None:
        return _scan(cell, x, h0)
    out, _ = torch.gru(x.to(w.dtype), h0[None], _flat_weights(cell),
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
    state = cell.zero_state(x.shape[0], cell.weight_ih)
    if cell.dtype is not None:
        return _scan(cell, x, state)
    h0, c0 = state
    out, _, _ = torch.lstm(
        x.to(cell.weight_ih.dtype), (h0[None], c0[None]), _flat_weights(cell),
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
