"""Global Style Tokens (counterpart of ``parakeet_tpu/nn/style_encoder.py``;
reference: parakeet/modules/style_encoder.py:24-308): a reference encoder
(strided 2-D convolutions and a GRU over time) distils a mel into one
vector, which attends over a bank of learned style tokens; the mixture is
the style embedding.

Submodules keep the flax names: ``ref_enc`` holds ``conv_{i}``,
``bn_{i}`` and the GRU cells ``GRUCell_{i}`` (flax names the cells of its
``nn.RNN`` so), ``stl`` holds ``gst_tokens_param`` and the bias-free
``q``/``k``/``v``.  The convolutions run in PyTorch's (B, C, T, F) layout;
the GRU reads the features in flax's (T, F, C) order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .rnn import GRUCell, gru_sequence

__all__ = ["ReferenceEncoder", "StyleTokenLayer", "StyleEncoder"]

_BN_EPS = 1e-5          # flax BatchNorm's default epsilon


def _same_pad(size: int, kernel: int, stride: int):
    """(low, high) padding of flax's SAME at ``stride``: the output has
    ceil(size / stride) positions, the odd padding element goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ReferenceEncoder(nn.Module):
    """Mel (B, T, n_mels) -> utterance vector (B, gru_units).

    Its BatchNorms use their running statistics even in training, as the
    JAX module's do (``use_running_average=True``); the GRU runs over
    every frame and the last one's output is the vector.
    """

    def __init__(self, n_mels: int = 80, conv_layers: int = 6,
                 conv_chans_list=(32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        self.conv_layers, self.gru_layers = conv_layers, gru_layers
        self.kernel, self.stride = conv_kernel_size, conv_stride
        cin, feat = 1, n_mels
        for i in range(conv_layers):
            cout = conv_chans_list[i]
            self.add_module(f"conv_{i}", nn.Conv2d(
                cin, cout, conv_kernel_size, stride=conv_stride, bias=False))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(cout, eps=_BN_EPS))
            cin, feat = cout, -(-feat // conv_stride)
        width = feat * cin
        for i in range(gru_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(width, gru_units))
            width = gru_units

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        x = speech[:, None]                          # (B, 1, T, F)
        for i in range(self.conv_layers):
            pt = _same_pad(x.shape[2], self.kernel, self.stride)
            pf = _same_pad(x.shape[3], self.kernel, self.stride)
            x = getattr(self, f"conv_{i}")(F.pad(x, (*pf, *pt)))
            bn = getattr(self, f"bn_{i}")
            x = torch.relu(F.batch_norm(x, bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias, training=False,
                                        eps=bn.eps))
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        for i in range(self.gru_layers):
            x = gru_sequence(getattr(self, f"GRUCell_{i}"), x)
        return x[:, -1, :]


class StyleTokenLayer(nn.Module):
    """Reference vector (B, ref_dim) -> style embedding (B, token_dim):
    multi-head attention of the vector over tanh of the tokens."""

    def __init__(self, ref_dim: int = 128, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4):
        super().__init__()
        self.n_heads, self.d_model = gst_heads, gst_token_dim
        dk = gst_token_dim // gst_heads
        self.gst_tokens_param = nn.Parameter(torch.zeros(gst_tokens, dk))
        self.q = nn.Linear(ref_dim, gst_token_dim, bias=False)
        self.k = nn.Linear(dk, gst_token_dim, bias=False)
        self.v = nn.Linear(dk, gst_token_dim, bias=False)

    def forward(self, ref_embs: torch.Tensor) -> torch.Tensor:
        b = ref_embs.shape[0]
        h, dk = self.n_heads, self.d_model // self.n_heads
        keys = torch.tanh(self.gst_tokens_param)
        n = keys.shape[0]
        q = self.q(ref_embs).view(b, h, dk)
        k = self.k(keys).view(1, n, h, dk)
        v = self.v(keys).view(1, n, h, dk)
        scores = torch.einsum("bhd,xnhd->bhn", q, k) / math.sqrt(dk)
        attn = torch.softmax(scores, dim=-1)
        return torch.einsum("bhn,xnhd->bhd", attn, v).reshape(b, self.d_model)


class StyleEncoder(nn.Module):
    """``ReferenceEncoder`` then ``StyleTokenLayer``: mel (B, T, n_mels)
    -> style embedding (B, gst_token_dim)."""

    def __init__(self, n_mels: int = 80, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 conv_layers: int = 6,
                 conv_chans_list=(32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        self.ref_enc = ReferenceEncoder(n_mels, conv_layers, conv_chans_list,
                                        conv_kernel_size, conv_stride,
                                        gru_layers, gru_units)
        self.stl = StyleTokenLayer(gru_units, gst_tokens, gst_token_dim,
                                   gst_heads)

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        return self.stl(self.ref_enc(speech))
