"""flax's mixed precision (``dtype=``) for the port's layers.

A flax module built with ``dtype=jnp.bfloat16`` keeps float32 parameters
and rounds its operands, weights and biases to bf16 where it computes:
``Dense``, ``Conv`` and ``Embed`` cast input, kernel and bias to ``dtype``
and return ``dtype``; ``LayerNorm`` and ``BatchNorm`` take their
statistics and normalize in float32 and return ``dtype``.  The layers
here are PyTorch's with that ``dtype`` argument: ``None`` (the default)
computes in the parameters' dtype exactly as the plain PyTorch layer.

A product of two bf16 operands is computed as flax's is: on CUDA tensors
cuBLAS's (cuDNN's) bf16 kernel, which accumulates in float32 and rounds
once; on CPU tensors the rounded operands widened to float32 and the
result rounded once (a product of two bf16 values is exact in float32, so
both are the same function up to the order of the sums).  Where JAX asks
for ``preferred_element_type=float32`` (attention's scores and context)
``mm_f32`` and ``bmm_f32`` keep the float32 result: the float32-output
bf16 GEMM on the card, whose gradients are JAX's (the float32 cotangent
times the other operand, widened, rounded to the operand's dtype).
Neither ever falls back to float32 operands on the card.

Inside ``cast_once`` each parameter is rounded to a dtype once and the
rounded copy reused: a loop that runs the same layers at every step (a
decoder's) casts its weights once, as XLA hoists the converts out of a
scan; a captured program (``utils/graphs.py``) rounds them in its
warm-up runs and its graph reads those copies, so a replay rounds no
weight.  The values are the same either way.

``sigmoid`` is ``jax.nn.sigmoid`` as XLA computes it at bf16:
``1 / (1 + exp(-x))`` rounded after each op (``torch.sigmoid`` rounds once,
and differs by an ulp on a third of bf16 inputs).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.casts import cast, cast_once, casts_once

__all__ = ["compute_dtype", "flax_dtype", "cast", "cast_product",
           "cast_once", "casts_once", "dense", "Dense", "LayerNorm",
           "Embedding", "mm_f32", "bmm_f32", "sigmoid"]

F32 = torch.float32


def compute_dtype(dtype: Optional[torch.dtype],
                  param: torch.Tensor) -> torch.dtype:
    """A module's compute dtype: its ``dtype``, else its parameters'."""
    return param.dtype if dtype is None else dtype


def flax_dtype(dtype: torch.dtype) -> Optional[torch.dtype]:
    """The ``dtype=`` argument of a model that computes in ``dtype`` on
    float32 parameters: None (the parameters' dtype) for float32."""
    return None if dtype == F32 else dtype


def cast_product(fn: Callable, dtype: torch.dtype,
                 *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)`` (a product: a matmul or a convolution) on the
    operands rounded to ``dtype``, returned in ``dtype`` (see the module's
    doc for the CPU form)."""
    xs = [cast(o, dtype) for o in operands]
    if dtype == F32 or xs[0].is_cuda:
        return fn(*xs)
    return fn(*(x.float() for x in xs)).to(dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)`` over a torch (out, in) ``weight``:
    ``x @ weight.T`` in ``dtype``, then ``+ bias`` in ``dtype``.  With
    ``dtype`` None (or the weight's) it is ``F.linear``."""
    if dtype is None or dtype == weight.dtype:
        return F.linear(x.to(weight.dtype), weight, bias)
    y = cast_product(F.linear, dtype, x, weight)
    return y if bias is None else y + cast(bias, dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's ``dtype`` (see ``dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's ``dtype``: with one, the statistics and
    the affine map in float32 and the result in ``dtype``."""

    def __init__(self, d: int, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(d, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None or self.dtype == self.weight.dtype:
            return super().forward(x.to(self.weight.dtype))
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` with flax's ``dtype``: the rows in ``dtype``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_embeddings, embedding_dim)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = super().forward(ids)
        return out if self.dtype is None else out.to(self.dtype)


class _ProductF32(torch.autograd.Function):
    """a @ b of two bf16 operands on the card, accumulated and returned in
    float32 (``torch.mm``/``torch.bmm`` with ``out_dtype``, which have no
    gradient of their own); the gradients as JAX's transpose of
    ``dot_general(preferred_element_type=float32)`` computes them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) accumulated and returned in float32, for
    float32 or bf16 operands: cuBLAS's float32-output GEMM on the card;
    on the CPU the operands widened to float32 (the same function)."""
    if a.dtype == F32:
        return a @ b
    if a.is_cuda:
        return _ProductF32.apply(a.reshape(-1, a.shape[-1]), b).reshape(
            *a.shape[:-1], -1)
    return a.float() @ b.float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, M, K) @ b (N, K, P) accumulated and returned in float32 (JAX's
    ``preferred_element_type=float32``): for bf16 operands on the card
    ``torch.bmm(..., out_dtype=float32)``, elsewhere the operands widened
    to float32 (the same function)."""
    if a.is_cuda and a.dtype != F32:
        return _ProductF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``torch.sigmoid`` in float32, and at a 16-bit
    dtype XLA's expansion op by op, ``1 / (1 + exp(-x))``."""
    if x.dtype in (F32, torch.float64):
        return torch.sigmoid(x)
    return torch.reciprocal(torch.exp(-x) + 1)
