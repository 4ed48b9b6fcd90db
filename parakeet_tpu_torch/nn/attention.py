"""Attention modules (counterpart of ``parakeet_tpu/nn/attention.py``;
reference: parakeet/modules/attention.py:22-348): the functional scaled
dot-product attention with its head dropout, single-head projected
attention, and the location-sensitive attention of Tacotron2's aligner.

``LocationSensitiveAttention`` runs one decoder step at a time:
``process_keys`` projects the keys once per utterance, outside the decode
loop; each step scores the query against them with the location feature,
a bias-free SAME convolution (kernel 31) over the stacked [previous,
cumulative] attention weights.  Both modules take flax's ``dtype``
(``nn/precision.py``); the location-sensitive softmax runs in float32
whatever the dtype, as in the JAX module.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.masking import masked_fill
from .conv import SameConv1d
from .dropout import Dropout
from .precision import Dense, cast_product, compute_dtype

__all__ = ["scaled_dot_product_attention", "MonoheadAttention",
           "LocationSensitiveAttention"]

_NEG_INF = -1e9


def scaled_dot_product_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, *,
        dropout_fn: Optional[Callable] = None, drop_n_heads: int = 0,
        rng: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (..., Tq, d), k (..., Tk, d), v (..., Tk, dv); ``mask``
    broadcastable to (..., Tq, Tk), True = keep.  Returns (out (..., Tq,
    dv), weights (..., Tq, Tk)).

    ``dropout_fn`` acts on the weights.  ``drop_n_heads`` > 0 zeroes that
    many heads an example, drawn from ``rng`` (the reference's drop_head,
    attention.py:65-108; a leading (B, H, ...) layout): of H uniform draws
    a row it keeps the heads above the ``drop_n_heads``-th smallest and
    scales them by H / (H - drop_n_heads)."""
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        scores = masked_fill(scores, ~mask, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if dropout_fn is not None:
        weights = dropout_fn(weights)
    out = torch.matmul(weights, v)
    if drop_n_heads > 0:
        if rng is None:
            raise ValueError("drop_n_heads requires an rng")
        b, h = out.shape[0], out.shape[1]
        draws = torch.rand((b, h), generator=rng, device=rng.device)
        kth = torch.sort(draws, dim=1).values[:, drop_n_heads - 1:
                                              drop_n_heads]
        keep = (draws > kth).to(out.device, out.dtype)
        scale = h / max(h - drop_n_heads, 1)
        out = out * keep[:, :, None, None] * scale
    return out, weights


class MonoheadAttention(nn.Module):
    """Single-head projected attention (reference attention.py:112-177):
    ``affine_q/k/v`` project q, k and v (``q_in``, ``k_in``, ``v_in`` wide,
    ``model_dim`` by default) to ``k_dim``, ``k_dim`` and ``v_dim``
    (``model_dim`` by default), ``affine_o`` the attention's output back
    to ``model_dim``, then dropout.  Returns (out, weights)."""

    def __init__(self, model_dim: int, dropout_rate: float = 0.0,
                 k_dim: Optional[int] = None, v_dim: Optional[int] = None,
                 q_in: Optional[int] = None, k_in: Optional[int] = None,
                 v_in: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k_dim = k_dim or model_dim
        v_dim = v_dim or model_dim
        self.affine_q = Dense(q_in or model_dim, k_dim, dtype=dtype)
        self.affine_k = Dense(k_in or model_dim, k_dim, dtype=dtype)
        self.affine_v = Dense(v_in or model_dim, v_dim, dtype=dtype)
        self.affine_o = Dense(v_dim, model_dim, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, q, k, v, mask=None, *, deterministic: bool = True,
                rng=None):
        out, weights = scaled_dot_product_attention(
            self.affine_q(q), self.affine_k(k), self.affine_v(v), mask)
        out = self.dropout(self.affine_o(out), deterministic=deterministic,
                           rng=rng)
        return out, weights


class LocationSensitiveAttention(nn.Module):
    """score_i = v . tanh(W_q q + W_k k_i + W_f f_i); the softmax runs in
    float32 and the weights return in the parameters' type."""

    def __init__(self, d_query: int, d_key: int, d_attention: int,
                 location_filters: int = 32, location_kernel_size: int = 31,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.query_layer = Dense(d_query, d_attention, bias=False,
                                 dtype=dtype)
        self.key_layer = Dense(d_key, d_attention, bias=False, dtype=dtype)
        self.location_conv = SameConv1d(2, location_filters,
                                        location_kernel_size, bias=False,
                                        dtype=dtype)
        self.location_layer = Dense(location_filters, d_attention,
                                    bias=False, dtype=dtype)
        self.value = Dense(d_attention, 1, bias=False, dtype=dtype)

    def process_keys(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, T, d_k) -> (B, T, d_attention); once, outside the loop."""
        return self.key_layer(keys)

    def forward(self, query: torch.Tensor, processed_keys: torch.Tensor,
                values: torch.Tensor, attention_weights: torch.Tensor,
                cum_attention_weights: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One alignment step: query (B, d_q), processed_keys (B, T,
        d_att), values (B, T, d_v), the previous and cumulative weights
        (B, T), mask (B, T) True at valid keys.  Returns (context (B, d_v),
        weights (B, T))."""
        dtype = compute_dtype(self.value.dtype, self.value.weight)
        processed_query = self.query_layer(query)[:, None, :]
        location = torch.stack([attention_weights, cum_attention_weights],
                               dim=-1).to(dtype)
        processed_location = self.location_layer(
            self.location_conv(location))
        energies = self.value(torch.tanh(
            processed_query + processed_keys + processed_location))[..., 0]
        if mask is not None:
            energies = torch.where(mask, energies,
                                   torch.full_like(energies, _NEG_INF))
        weights = torch.softmax(energies.float(), dim=-1).to(dtype)
        context = cast_product(torch.bmm, dtype, weights[:, None, :],
                               values)[:, 0]
        return context, weights
