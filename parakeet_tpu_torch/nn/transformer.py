"""Transformer encoder blocks (counterpart of
``parakeet_tpu/nn/transformer.py``).

Layout is (B, T, C) throughout, as in the JAX package.  Submodule names
follow the flax parameter tree (``self_attn.q``, ``MultiLayerConv_0.Conv_0``,
``layer_{i}``, ...) so that ``bridge.load_flax_params`` finds every weight
by its path.  The compute dtype is the parameters' dtype
(``module.to(torch.bfloat16)``).

As in flax, every forward takes ``deterministic`` (default True: no
dropout) and, when it is False, the ``torch.Generator`` that the dropout
masks are drawn from (``rng``); ``module.training`` plays no part.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.positional import sinusoid_position_encoding
from .conv import SameConv1d
from .dropout import Dropout
from .flash import AUTO_FLASH_MIN_T

__all__ = ["PositionalEncoding", "ScaledPositionalEncoding",
           "MultiHeadAttention", "PositionwiseFeedForward", "MultiLayerConv",
           "EncoderLayer", "TransformerEncoder", "AUTO_FLASH_MIN_T"]

_NEG_INF = -1e9
_LN_EPS = 1e-6          # flax LayerNorm's default epsilon


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=_LN_EPS)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE, or with ``scaled`` x + alpha * PE with a learnable
    alpha (no sqrt(d) then); then dropout."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 scaled: bool = False, init_alpha: float = 1.0):
        super().__init__()
        self.d_model = d_model
        self.scaled = scaled
        self.dropout = Dropout(dropout_rate)
        if scaled:
            self.alpha = nn.Parameter(torch.full((1,), float(init_alpha)))

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        pe = sinusoid_position_encoding(x.shape[1], self.d_model,
                                        dtype=x.dtype, device=x.device)[None]
        if self.scaled:
            x = x + self.alpha.to(x.dtype) * pe
        else:
            x = x * math.sqrt(self.d_model) + pe
        return self.dropout(x, deterministic=deterministic, rng=rng)


def ScaledPositionalEncoding(d_model: int, dropout_rate: float = 0.1,
                             init_alpha: float = 1.0):
    return PositionalEncoding(d_model, dropout_rate, scaled=True,
                              init_alpha=init_alpha)


class MultiHeadAttention(nn.Module):
    """Multi-head scaled dot-product attention.

    ``mask``: bool, True = attendable, broadcastable to (B, 1, Tq, Tk)
    (ndim 3 means (B, 1, Tk)).  The dense core runs scores and softmax in
    float32, *replaces* masked scores by -1e9 and drops attention weights
    at ``dropout_rate`` when not deterministic, as in the JAX package.

    ``attn_core``: an optional replacement for the dense core,
    ``(q, k, v, mask) -> (B, Tq, H, dk)`` over the projected heads (see
    ``nn/flash.py``), dispatched as ``parakeet_tpu/nn/transformer.py``
    does: a core has no attention dropout, so training with a nonzero rate
    raises ``ValueError``, unless the core sets ``dense_fallback`` (the
    'auto' core), which falls back to the dense path; a core that returns
    None also means the dense path.
    """

    def __init__(self, n_heads: int, d_model: int, dropout_rate: float = 0.0,
                 attn_core=None):
        super().__init__()
        self.n_heads, self.d_model = n_heads, d_model
        self.dropout_rate = dropout_rate
        self.attn_core = attn_core
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout_rate)

    def forward(self, query, key, value, mask=None, *,
                deterministic: bool = True, rng=None) -> torch.Tensor:
        b, tq, _ = query.shape
        tk = key.shape[1]
        h = self.n_heads
        dk = self.d_model // h
        q = self.q(query).view(b, tq, h, dk)
        k = self.k(key).view(b, tk, h, dk)
        v = self.v(value).view(b, tk, h, dk)
        if self.attn_core is not None:
            auto = getattr(self.attn_core, "dense_fallback", False)
            if self.dropout_rate > 0.0 and not deterministic:
                if not auto:
                    raise ValueError(
                        "attn_core skips attention dropout; training with "
                        f"dropout_rate={self.dropout_rate} and a custom "
                        "core would silently lose regularization (set the "
                        "rate to 0 or train with the dense path)")
            else:
                core_out = self.attn_core(q, k, v, mask)
                if core_out is not None:
                    return self.out(core_out.to(query.dtype).reshape(
                        b, tq, self.d_model))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(dk)
        if mask is not None:
            if mask.ndim == 3:
                mask = mask[:, None]                # (B, 1, Tq, Tk)
            scores = torch.where(mask, scores, _NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(query.dtype)
        attn = self.attn_dropout(attn, deterministic=deterministic, rng=rng)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        return self.out(out.to(query.dtype).reshape(b, tq, self.d_model))


class PositionwiseFeedForward(nn.Module):
    """linear -> relu -> dropout -> linear."""

    def __init__(self, hidden_units: int, d_model: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.Dense_0 = nn.Linear(d_model, hidden_units)
        self.Dense_1 = nn.Linear(hidden_units, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, *, deterministic: bool = True, rng=None):
        h = self.dropout(F.relu(self.Dense_0(x)),
                         deterministic=deterministic, rng=rng)
        return self.Dense_1(h)


class MultiLayerConv(nn.Module):
    """conv1d -> relu -> dropout -> conv1d (or -> linear with
    ``second_linear``)."""

    def __init__(self, hidden_units: int, d_model: int, kernel_size: int = 1,
                 dropout_rate: float = 0.1, second_linear: bool = False):
        super().__init__()
        self.Conv_0 = SameConv1d(d_model, hidden_units, kernel_size)
        self.second_linear = second_linear
        self.dropout = Dropout(dropout_rate)
        if second_linear:
            self.Dense_0 = nn.Linear(hidden_units, d_model)
        else:
            self.Conv_1 = SameConv1d(hidden_units, d_model, kernel_size)

    def forward(self, x, *, deterministic: bool = True, rng=None):
        h = self.dropout(F.relu(self.Conv_0(x)), deterministic=deterministic,
                         rng=rng)
        return self.Dense_0(h) if self.second_linear else self.Conv_1(h)


def _make_positionwise(layer_type: str, units: int, d_model: int,
                       kernel_size: int, dropout: float):
    """(flax auto-name, module) of the positionwise block."""
    if layer_type == "linear":
        return ("PositionwiseFeedForward_0",
                PositionwiseFeedForward(units, d_model, dropout))
    if layer_type == "conv1d":
        return "MultiLayerConv_0", MultiLayerConv(units, d_model, kernel_size,
                                                  dropout)
    if layer_type == "conv1d-linear":
        return "MultiLayerConv_0", MultiLayerConv(units, d_model, kernel_size,
                                                  dropout, second_linear=True)
    raise ValueError(f"unknown positionwise layer type {layer_type!r}")


class EncoderLayer(nn.Module):
    """Self-attention encoder layer, pre- or post-LN, with dropout on both
    residual branches."""

    def __init__(self, d_model: int, n_heads: int, units: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1, attn_core=None):
        super().__init__()
        if concat_after:
            raise NotImplementedError("concat_after=True is not ported yet")
        self.normalize_before = normalize_before
        self.norm1 = _layer_norm(d_model)
        self.norm2 = _layer_norm(d_model)
        self.self_attn = MultiHeadAttention(n_heads, d_model,
                                            attn_dropout_rate, attn_core)
        self.ff_name, ff = _make_positionwise(
            positionwise_layer_type, units, d_model,
            positionwise_conv_kernel_size, dropout_rate)
        self.add_module(self.ff_name, ff)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask=None, *, deterministic: bool = True,
                rng=None):
        kw = dict(deterministic=deterministic, rng=rng)
        residual = x
        if self.normalize_before:
            x = self.norm1(x)
        x = residual + self.dropout(self.self_attn(x, x, x, mask, **kw), **kw)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        if self.normalize_before:
            x = self.norm2(x)
        x = residual + self.dropout(getattr(self, self.ff_name)(x, **kw),
                                    **kw)
        if not self.normalize_before:
            x = self.norm2(x)
        return x


class TransformerEncoder(nn.Module):
    """Token- or feature-input transformer encoder; returns (B, T, d).

    ``input_layer``: "embed" (token ids; padding ids are zeroed by a
    multiply, as in the JAX package) or None (features already ``d_model``
    wide).  The JAX package's "linear" input layer is not ported yet.
    """

    def __init__(self, d_model: int = 384, n_heads: int = 4,
                 units: int = 1536, num_layers: int = 6,
                 input_layer: Optional[str] = "embed", vocab_size: int = 0,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attn_dropout_rate: float = 0.0,
                 use_scaled_pos_enc: bool = True, init_alpha: float = 1.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 positionwise_layer_type: str = "conv1d",
                 positionwise_conv_kernel_size: int = 1,
                 padding_idx: int = 0, attn_core=None):
        super().__init__()
        self.input_layer = input_layer
        self.padding_idx = padding_idx
        self.normalize_before = normalize_before
        self.num_layers = num_layers
        if input_layer == "embed":
            self.embed = nn.Embedding(vocab_size, d_model)
        elif input_layer is not None:
            raise ValueError(f"unknown input_layer {input_layer!r}")
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate,
                                          scaled=use_scaled_pos_enc,
                                          init_alpha=init_alpha)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, n_heads, units, dropout_rate, attn_dropout_rate,
                normalize_before, concat_after, positionwise_layer_type,
                positionwise_conv_kernel_size, attn_core))
        if normalize_before:
            self.after_norm = _layer_norm(d_model)

    def forward(self, xs, mask=None, *, deterministic: bool = True,
                rng=None):
        kw = dict(deterministic=deterministic, rng=rng)
        if self.input_layer == "embed":
            emb = self.embed(xs)
            x = emb * (xs != self.padding_idx)[..., None].to(emb.dtype)
        else:
            x = xs
        x = self.pos_enc(x, **kw)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, **kw)
        if self.normalize_before:
            x = self.after_norm(x)
        return x
