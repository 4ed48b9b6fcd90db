"""Transformer encoder blocks (counterpart of
``parakeet_tpu/nn/transformer.py``).

Layout is (B, T, C) throughout, as in the JAX package.  Submodule names
follow the flax parameter tree (``self_attn.q``, ``MultiLayerConv_0.Conv_0``,
``layer_{i}``, ...) so that ``bridge.load_flax_params`` finds every weight
by its path.

Every module takes flax's ``dtype`` (``nn/precision.py``): with
``torch.bfloat16`` the parameters stay float32 and the products run in
bf16 at the JAX modules' cast points, while LayerNorm's statistics, the
dense attention's scores, softmax and context sums stay float32
(``preferred_element_type=float32``: ``precision.bmm_f32``, the
float32-output bf16 GEMM on the card); the flash core takes the bf16
heads.  ``None`` computes in the parameters' dtype.

As in flax, every forward takes ``deterministic`` (default True: no
dropout) and, when it is False, the ``torch.Generator`` that the dropout
masks are drawn from (``rng``); ``module.training`` plays no part.

An autoregressive decode keeps each self-attention's keys and values in a
``KVCache``: buffers (B, t_max, H, dk) allocated once, written a step at a
time in place, so that every step of a decode unrolled in Python has
static shapes and the whole loop may be captured in one CUDA graph.
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
from .precision import Dense, Embedding, LayerNorm, bmm_f32

__all__ = ["PositionalEncoding", "ScaledPositionalEncoding",
           "MultiHeadAttention", "PositionwiseFeedForward", "MultiLayerConv",
           "EncoderLayer", "TransformerEncoder", "KVCache", "DecoderLayer",
           "TransformerDecoder", "AUTO_FLASH_MIN_T"]

_NEG_INF = -1e9
_LN_EPS = 1e-6          # flax LayerNorm's default epsilon


def _layer_norm(d: int, dtype: Optional[torch.dtype]) -> LayerNorm:
    return LayerNorm(d, _LN_EPS, dtype)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE, or with ``scaled`` x + alpha * PE with a learnable
    alpha (no sqrt(d) then); then dropout."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 scaled: bool = False, init_alpha: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.scaled = scaled
        self.dtype = dtype
        self.dropout = Dropout(dropout_rate)
        if scaled:
            self.alpha = nn.Parameter(torch.full((1,), float(init_alpha)))

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng=None, start_pos: int = 0,
                pe: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pe``: the (1, T, d) rows of the table, when the caller holds
        them (a decode loop slices one table made before the loop);
        otherwise they are made here from ``start_pos``, in ``dtype`` as
        the JAX module makes them."""
        dt = self.dtype or x.dtype
        if pe is None:
            pe = sinusoid_position_encoding(
                x.shape[1], self.d_model, start_pos=start_pos,
                dtype=dt, device=x.device,
                in_dtype=self.dtype is not None)[None]
        if self.scaled:
            x = x + self.alpha.to(dt) * pe
        elif self.dtype is None:
            x = x * math.sqrt(self.d_model) + pe
        else:       # sqrt(d) rounded to the dtype, as jnp.sqrt computes it
            x = x * torch.sqrt(torch.tensor(float(self.d_model),
                                            dtype=dt)).item() + pe
        return self.dropout(x, deterministic=deterministic, rng=rng)


def ScaledPositionalEncoding(d_model: int, dropout_rate: float = 0.1,
                             init_alpha: float = 1.0,
                             dtype: Optional[torch.dtype] = None):
    return PositionalEncoding(d_model, dropout_rate, scaled=True,
                              init_alpha=init_alpha, dtype=dtype)


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

    ``kv``: the projected (K, V) heads of ``project_kv``, which a decode
    loop computes once for its cross-attention.  ``cache``: a ``KVCache``
    that this call's keys and values are written into at ``cache_index``;
    the attention then runs over the cache (see ``KVCache.append``).  With
    ``return_weights`` the call returns (output, attention weights
    (B, H, Tq, Tk), after dropout, in the compute dtype).
    """

    def __init__(self, n_heads: int, d_model: int, dropout_rate: float = 0.0,
                 attn_core=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads, self.d_model = n_heads, d_model
        self.dropout_rate = dropout_rate
        self.attn_core = attn_core
        self.q = Dense(d_model, d_model, dtype=dtype)
        self.k = Dense(d_model, d_model, dtype=dtype)
        self.v = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)
        self.attn_dropout = Dropout(dropout_rate)

    def project_kv(self, key, value):
        """The projected (K, V) heads (B, Tk, H, dk) of ``key`` and
        ``value``."""
        b, tk, _ = key.shape
        h = self.n_heads
        dk = self.d_model // h
        return (self.k(key).view(b, tk, h, dk),
                self.v(value).view(b, tk, h, dk))

    def forward(self, query, key, value, mask=None, *,
                deterministic: bool = True, rng=None, kv=None,
                cache: Optional["KVCache"] = None, cache_index: int = 0,
                return_weights: bool = False):
        b, tq, _ = query.shape
        h = self.n_heads
        dk = self.d_model // h
        q = self.q(query).view(b, tq, h, dk)
        k, v = kv if kv is not None else self.project_kv(key, value)
        core = self.attn_core
        auto = getattr(core, "dense_fallback", False)
        if cache is not None:
            if core is not None and not auto:
                raise ValueError("attn_core does not support KV caches")
            core = None                 # 'auto' decodes on the dense path
            k, v = cache.append(cache_index, k, v)
        if core is not None:
            if self.dropout_rate > 0.0 and not deterministic:
                if not auto:
                    raise ValueError(
                        "attn_core skips attention dropout; training with "
                        f"dropout_rate={self.dropout_rate} and a custom "
                        "core would silently lose regularization (set the "
                        "rate to 0 or train with the dense path)")
            else:
                core_out = core(q, k, v, mask)
                if core_out is not None:
                    out = self.out(core_out.to(q.dtype).reshape(
                        b, tq, self.d_model))
                    # a core keeps no weights, as in the JAX package
                    return (out, None) if return_weights else out
        tk = k.shape[1]
        scores = bmm_f32(q.transpose(1, 2).reshape(b * h, tq, dk),
                         k.permute(0, 2, 3, 1).reshape(b * h, dk, tk)
                         ).view(b, h, tq, tk) / math.sqrt(dk)
        if mask is not None:
            if mask.ndim == 3:
                mask = mask[:, None]                # (B, 1, Tq, Tk)
            scores = torch.where(mask, scores, _NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        attn = self.attn_dropout(attn, deterministic=deterministic, rng=rng)
        out = bmm_f32(attn.reshape(b * h, tq, tk),
                      v.transpose(1, 2).reshape(b * h, tk, dk)
                      ).view(b, h, tq, dk).transpose(1, 2)
        out = self.out(out.to(q.dtype).reshape(b, tq, self.d_model))
        return (out, attn) if return_weights else out


class PositionwiseFeedForward(nn.Module):
    """linear -> relu -> dropout -> linear."""

    def __init__(self, hidden_units: int, d_model: int,
                 dropout_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(d_model, hidden_units, dtype=dtype)
        self.Dense_1 = Dense(hidden_units, d_model, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, *, deterministic: bool = True, rng=None):
        h = self.dropout(F.relu(self.Dense_0(x)),
                         deterministic=deterministic, rng=rng)
        return self.Dense_1(h)


class MultiLayerConv(nn.Module):
    """conv1d -> relu -> dropout -> conv1d (or -> linear with
    ``second_linear``)."""

    def __init__(self, hidden_units: int, d_model: int, kernel_size: int = 1,
                 dropout_rate: float = 0.1, second_linear: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = SameConv1d(d_model, hidden_units, kernel_size,
                                 dtype=dtype)
        self.second_linear = second_linear
        self.dropout = Dropout(dropout_rate)
        if second_linear:
            self.Dense_0 = Dense(hidden_units, d_model, dtype=dtype)
        else:
            self.Conv_1 = SameConv1d(hidden_units, d_model, kernel_size,
                                     dtype=dtype)

    def forward(self, x, *, deterministic: bool = True, rng=None):
        h = self.dropout(F.relu(self.Conv_0(x)), deterministic=deterministic,
                         rng=rng)
        return self.Dense_0(h) if self.second_linear else self.Conv_1(h)


def _make_positionwise(layer_type: str, units: int, d_model: int,
                       kernel_size: int, dropout: float, dtype):
    """(flax auto-name, module) of the positionwise block."""
    if layer_type == "linear":
        return ("PositionwiseFeedForward_0",
                PositionwiseFeedForward(units, d_model, dropout, dtype))
    if layer_type == "conv1d":
        return "MultiLayerConv_0", MultiLayerConv(units, d_model, kernel_size,
                                                  dropout, dtype=dtype)
    if layer_type == "conv1d-linear":
        return "MultiLayerConv_0", MultiLayerConv(units, d_model, kernel_size,
                                                  dropout, second_linear=True,
                                                  dtype=dtype)
    raise ValueError(f"unknown positionwise layer type {layer_type!r}")


class EncoderLayer(nn.Module):
    """Self-attention encoder layer, pre- or post-LN, with dropout on both
    residual branches; with ``concat_after`` the attention's branch is
    ``concat_proj([x, attention(x)])`` (x after the pre-LN), without
    dropout, as in the JAX package."""

    def __init__(self, d_model: int, n_heads: int, units: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1, attn_core=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.normalize_before = normalize_before
        self.norm1 = _layer_norm(d_model, dtype)
        self.norm2 = _layer_norm(d_model, dtype)
        self.self_attn = MultiHeadAttention(n_heads, d_model,
                                            attn_dropout_rate, attn_core,
                                            dtype)
        self.concat_after = concat_after
        if concat_after:
            self.concat_proj = Dense(2 * d_model, d_model, dtype=dtype)
        self.ff_name, ff = _make_positionwise(
            positionwise_layer_type, units, d_model,
            positionwise_conv_kernel_size, dropout_rate, dtype)
        self.add_module(self.ff_name, ff)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask=None, *, deterministic: bool = True,
                rng=None, return_weights: bool = False):
        """(B, T, d), or with ``return_weights`` ((B, T, d), the
        self-attention's weights (B, H, T, T))."""
        kw = dict(deterministic=deterministic, rng=rng)
        residual = x
        if self.normalize_before:
            x = self.norm1(x)
        attn_out = self.self_attn(x, x, x, mask, return_weights=return_weights,
                                  **kw)
        if return_weights:
            attn_out, weights = attn_out
        if self.concat_after:
            x = residual + self.concat_proj(torch.cat([x, attn_out], dim=-1))
        else:
            x = residual + self.dropout(attn_out, **kw)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        if self.normalize_before:
            x = self.norm2(x)
        x = residual + self.dropout(getattr(self, self.ff_name)(x, **kw),
                                    **kw)
        if not self.normalize_before:
            x = self.norm2(x)
        return (x, weights) if return_weights else x


class TransformerEncoder(nn.Module):
    """Token- or feature-input transformer encoder; returns (B, T, d).

    ``input_layer``: "embed" (token ids; padding ids are zeroed by a
    multiply, as in the JAX package), "linear" (features ``input_dim``
    wide, ``d_model`` by default, projected by the ``embed`` Dense) or
    None (features already ``d_model`` wide).
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
                 padding_idx: int = 0, attn_core=None,
                 input_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_layer = input_layer
        self.padding_idx = padding_idx
        self.normalize_before = normalize_before
        self.num_layers = num_layers
        if input_layer == "embed":
            self.embed = Embedding(vocab_size, d_model, dtype=dtype)
        elif input_layer == "linear":
            self.embed = Dense(input_dim or d_model, d_model, dtype=dtype)
        elif input_layer is not None:
            raise ValueError(f"unknown input_layer {input_layer!r}")
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate,
                                          scaled=use_scaled_pos_enc,
                                          init_alpha=init_alpha, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, n_heads, units, dropout_rate, attn_dropout_rate,
                normalize_before, concat_after, positionwise_layer_type,
                positionwise_conv_kernel_size, attn_core, dtype))
        if normalize_before:
            self.after_norm = _layer_norm(d_model, dtype)

    def forward(self, xs, mask=None, *, deterministic: bool = True,
                rng=None, return_attns: bool = False):
        """(B, T, d), or with ``return_attns`` ((B, T, d), the layers'
        self-attention weights stacked (L, B, H, T, T))."""
        kw = dict(deterministic=deterministic, rng=rng)
        if self.input_layer == "embed":
            emb = self.embed(xs)
            x = emb * (xs != self.padding_idx)[..., None].to(emb.dtype)
        elif self.input_layer == "linear":
            x = self.embed(xs)
        else:
            x = xs
        x = self.pos_enc(x, **kw)
        attns = []
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, return_weights=return_attns,
                                            **kw)
            if return_attns:
                x, attn = x
                attns.append(attn)
        if self.normalize_before:
            x = self.after_norm(x)
        return (x, torch.stack(attns)) if return_attns else x


class KVCache:
    """One self-attention's keys and values during an autoregressive
    decode: (B, t_max, H, dk) buffers, zero until written.

    ``append`` writes a call's rows at ``index`` in place and returns the
    rows written so far, ``[:index + n]``: each step's shape differs,
    which the port's decode loop, unrolled in Python, allows.  The JAX
    package's scan needs one shape for every step and attends over the
    whole buffer masked to the written rows; both give the same values up
    to the order of the sums (a masked score's weight is exactly 0).
    """

    def __init__(self, batch: int, t_max: int, heads: int, dk: int,
                 dtype: torch.dtype, device):
        self.k = torch.zeros((batch, t_max, heads, dk), dtype=dtype,
                             device=device)
        self.v = torch.zeros_like(self.k)

    def append(self, index: int, k: torch.Tensor, v: torch.Tensor):
        n = k.shape[1]
        self.k[:, index:index + n] = k.to(self.k.dtype)
        self.v[:, index:index + n] = v.to(self.v.dtype)
        return self.k[:, :index + n], self.v[:, :index + n]


class DecoderLayer(nn.Module):
    """Masked self-attention, cross-attention over the encoder memory and
    a linear feed-forward block, pre- or post-LN, dropout on each residual
    branch; with ``concat_after`` the two attentions' branches are
    ``concat_proj1([x, self_attn(x)])`` and ``concat_proj2([x,
    src_attn(x)])`` (x after the pre-LN), without dropout.  Submodules keep
    the flax names: ``norm1``-``norm3``, ``self_attn``, ``src_attn``,
    ``ff``, ``concat_proj1``, ``concat_proj2``."""

    def __init__(self, d_model: int, n_heads: int, units: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.0,
                 src_attn_dropout_rate: Optional[float] = None,
                 normalize_before: bool = True, concat_after: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.normalize_before = normalize_before
        self.norm1 = _layer_norm(d_model, dtype)
        self.norm2 = _layer_norm(d_model, dtype)
        self.norm3 = _layer_norm(d_model, dtype)
        self.self_attn = MultiHeadAttention(n_heads, d_model,
                                            attn_dropout_rate, dtype=dtype)
        self.src_attn = MultiHeadAttention(
            n_heads, d_model, attn_dropout_rate
            if src_attn_dropout_rate is None else src_attn_dropout_rate,
            dtype=dtype)
        self.ff = PositionwiseFeedForward(units, d_model, dropout_rate,
                                          dtype)
        self.dropout = Dropout(dropout_rate)
        self.concat_after = concat_after
        if concat_after:
            self.concat_proj1 = Dense(2 * d_model, d_model, dtype=dtype)
            self.concat_proj2 = Dense(2 * d_model, d_model, dtype=dtype)

    def cross_kv(self, memory):
        """This layer's projected cross-attention (K, V) over ``memory``,
        the same at every step of a decode."""
        return self.src_attn.project_kv(memory, memory)

    def _residual(self, x, norm, fn, kw, concat=None):
        """x + dropout(fn(norm(x))) (pre-LN) or norm(x + dropout(fn(x))),
        with ``concat([y, fn(y)])`` in place of the dropout branch when
        ``concat`` is given; returns (new x, whatever else fn returned)."""
        y = norm(x) if self.normalize_before else x
        out, extra = fn(y)
        if concat is not None:
            x = x + concat(torch.cat([y, out], dim=-1))
        else:
            x = x + self.dropout(out, **kw)
        return (x if self.normalize_before else norm(x)), extra

    def forward(self, x, memory, self_mask=None, cross_mask=None, *,
                deterministic: bool = True, rng=None,
                cache: Optional[KVCache] = None, cache_index: int = 0,
                cross_kv=None):
        """Returns (x (B, Tq, d), (self-attention weights, cross-attention
        weights))."""
        kw = dict(deterministic=deterministic, rng=rng)
        concat = self.concat_after
        x, sa_w = self._residual(x, self.norm1, lambda y: self.self_attn(
            y, y, y, self_mask, cache=cache, cache_index=cache_index,
            return_weights=True, **kw), kw,
            self.concat_proj1 if concat else None)
        x, ca_w = self._residual(x, self.norm2, lambda y: self.src_attn(
            y, memory, memory, cross_mask, kv=cross_kv, return_weights=True,
            **kw), kw, self.concat_proj2 if concat else None)
        x, _ = self._residual(x, self.norm3,
                              lambda y: (self.ff(y, **kw), None), kw)
        return x, (sa_w, ca_w)


class TransformerDecoder(nn.Module):
    """Decoder stack over inputs already ``d_model`` wide, or with
    ``input_layer="linear"`` over inputs ``input_dim`` wide (``d_model``
    by default) projected by ``input_proj``.

    ``forward`` returns (hs, self-attention weights (L, B, H, Tq, Tk),
    cross-attention weights (L, B, H, Tq, T_enc)).  For one decode step,
    pass ``caches`` (a ``KVCache`` a layer, from ``new_caches``), the
    step's position ``start_pos``, ``cross_kvs`` from
    ``precompute_cross_kv`` and the positional rows ``pos_pe``.
    """

    def __init__(self, d_model: int = 384, n_heads: int = 4,
                 units: int = 1536, num_layers: int = 6,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attn_dropout_rate: float = 0.0,
                 src_attn_dropout_rate: Optional[float] = None,
                 use_scaled_pos_enc: bool = True, init_alpha: float = 1.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 input_layer: Optional[str] = None,
                 input_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        if input_layer == "linear":
            self.input_proj = Dense(input_dim or d_model, d_model,
                                    dtype=dtype)
        elif input_layer is not None:
            raise ValueError(f"unknown input_layer {input_layer!r}")
        self.input_layer = input_layer
        self.d_model, self.n_heads = d_model, n_heads
        self.num_layers = num_layers
        self.normalize_before = normalize_before
        self.pos_enc = PositionalEncoding(d_model, positional_dropout_rate,
                                          scaled=use_scaled_pos_enc,
                                          init_alpha=init_alpha, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                d_model, n_heads, units, dropout_rate, attn_dropout_rate,
                src_attn_dropout_rate, normalize_before, concat_after,
                dtype))
        if normalize_before:
            self.after_norm = _layer_norm(d_model, dtype)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def precompute_cross_kv(self, memory):
        """Each layer's cross-attention (K, V) over ``memory``: what a
        decode loop computes once, before its first step."""
        return [layer.cross_kv(memory) for layer in self.layers()]

    def new_caches(self, batch: int, t_max: int, dtype, device):
        """One empty ``KVCache`` a layer for a decode of ``t_max``
        steps, in the compute dtype (``dtype`` when the decoder has
        none)."""
        dtype = self.dtype or dtype
        dk = self.d_model // self.n_heads
        return [KVCache(batch, t_max, self.n_heads, dk, dtype, device)
                for _ in range(self.num_layers)]

    def forward(self, xs, memory, self_mask=None, cross_mask=None, *,
                deterministic: bool = True, rng=None, caches=None,
                start_pos: int = 0, cross_kvs=None, pos_pe=None):
        kw = dict(deterministic=deterministic, rng=rng)
        if self.input_layer == "linear":
            xs = self.input_proj(xs)
        x = self.pos_enc(xs, start_pos=start_pos, pe=pos_pe, **kw)
        self_attns, cross_attns = [], []
        for i, layer in enumerate(self.layers()):
            x, (sa, ca) = layer(
                x, memory, self_mask, cross_mask,
                cache=None if caches is None else caches[i],
                cache_index=start_pos,
                cross_kv=None if cross_kvs is None else cross_kvs[i], **kw)
            self_attns.append(sa)
            cross_attns.append(ca)
        if self.normalize_before:
            x = self.after_norm(x)
        return x, torch.stack(self_attns), torch.stack(cross_attns)
