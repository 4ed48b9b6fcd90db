"""Fused Parallel WaveGAN residual stack, inference (kernel K1).

Counterpart of ``parakeet_tpu/ops/pallas/pwg_stack.py::fused_residual_stack``
(the Pallas TPU kernel ``_group_kernel``), with the same signature and
contract: x (B, T, cr) and c (B, T, ca) plus the stacked (L, ...)
weight-norm-folded weights of ``ResidualStack`` give
``(x_final (B, T, cr) bf16, skip_sum (B, T, cr) float32)``.

- On CUDA tensors it launches the hand-written kernel in
  ``parakeet_tpu_torch/csrc/pwg_stack.cu``, one launch per layer, or
  raises.  ``fused_residual_stack.launches`` counts those launches.
- On CPU tensors it runs ``fused_residual_stack_reference``, the plain
  PyTorch statement of the same arithmetic.

Rounding points, copied from the TPU kernel: x and c enter as bf16;
inside a group of layers x is carried in float32; every matmul operand
is bf16 with float32 accumulation; the gate bias rides the aux matmul
through a constant-1 column, so it is rounded to bf16; h is rounded to
bf16; the skip sum and the [skip | res] biases are float32; x is rounded
to bf16 at the end of each group.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..geometry import time_shift
from ._build import load_library

__all__ = ["fused_residual_stack", "fused_residual_stack_reference",
           "fused_stack_supported", "pack_stack_weights"]

_SQRT_HALF = math.sqrt(0.5)
_F32, _BF16 = torch.float32, torch.bfloat16


def fused_stack_supported(residual_channels: int, gate_channels: int,
                          skip_channels: int, kernel_size: int,
                          layers: int, stacks: int,
                          aux_channels: Optional[int] = 80) -> bool:
    """Whether ``ResidualStack`` can run this configuration fused."""
    if kernel_size != 3 or layers % stacks != 0:
        return False
    if aux_channels is None or not 0 < aux_channels <= 127:
        return False
    if gate_channels != 2 * residual_channels:
        return False
    if residual_channels != skip_channels:
        return False
    # the kernel's instances; at 128 the weights outgrow shared memory
    return residual_channels in (32, 64)


def _aux_width(ca: int) -> int:
    """Columns of [c | 1 | zeros] in the gate operand: ca + 1 rounded up
    to the tensor-core depth of 16."""
    return -(-(ca + 1) // 16) * 16


def pack_stack_weights(weights: Dict[str, torch.Tensor], cr: int, ca: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stacked effective weights -> the kernel's operands.

    ``weights``: conv (L, 3, cr, 2cr), aux (L, ca, 2cr), skip and out
    (L, cr, cr), optional conv_b (L, 2cr), skip_b and out_b (L, cr).
    Returns wg (L, 3cr + _aux_width(ca), 2cr) bf16 whose rows are
    [tap t-d | tap t+d | center tap | aux | gate bias | zeros], wso
    (L, cr, 2cr) bf16 = [W_skip | W_out], and bso (L, 2cr) float32.
    """
    conv = weights["conv"]
    n, dev = conv.shape[0], conv.device
    kp = 3 * cr + _aux_width(ca)
    wg = torch.zeros((n, kp, 2 * cr), dtype=_F32, device=dev)
    wg[:, :cr] = conv[:, 0]
    wg[:, cr:2 * cr] = conv[:, 2]
    wg[:, 2 * cr:3 * cr] = conv[:, 1]
    wg[:, 3 * cr:3 * cr + ca] = weights["aux"]
    if weights.get("conv_b") is not None:
        wg[:, 3 * cr + ca] = weights["conv_b"]
    wso = torch.cat([weights["skip"], weights["out"]], dim=2)
    if weights.get("skip_b") is None:
        bso = torch.zeros((n, 2 * cr), dtype=_F32, device=dev)
    else:
        bso = torch.cat([weights["skip_b"], weights["out_b"]], dim=1)
    return (wg.to(_BF16), wso.to(_BF16).contiguous(),
            bso.to(_F32).contiguous())


def _bf(a: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return float32 (exact products in a f32 matmul)."""
    return a.to(_BF16).to(_F32)


def fused_residual_stack_reference(x, c, weights, *,
                                   dilations: Sequence[int], stacks: int):
    """Plain PyTorch version of K1, with the kernel's rounding points.

    Every product is ``a.bfloat16().float() @ w.bfloat16().float()``, so the
    result does not depend on how a backend accumulates bf16.
    """
    b, t, cr = x.shape
    ca = c.shape[-1]
    wg, wso, bso = pack_stack_weights(weights, cr, ca)
    per = wg.shape[0] // stacks
    pad = wg.shape[1] - 3 * cr - ca - 1
    ones = torch.ones((b, t, 1), dtype=_F32, device=x.device)
    zeros = torch.zeros((b, t, pad), dtype=_F32, device=x.device)
    aux = torch.cat([_bf(c), ones, zeros], dim=-1)       # [c | 1 | 0]
    xs = _bf(x)
    skip = None
    for i, d in enumerate(dilations):
        xb = _bf(xs)
        a = torch.cat([time_shift(xb, -d), time_shift(xb, d), xb, aux], -1)
        g = a @ wg[i].to(_F32)
        h = _bf(torch.tanh(g[..., :cr]) * torch.sigmoid(g[..., cr:]))
        so = h @ wso[i].to(_F32) + bso[i]
        skip = so[..., :cr] if skip is None else skip + so[..., :cr]
        xs = (so[..., cr:] + xs) * _SQRT_HALF
        if (i + 1) % per == 0:                   # end of a group
            xs = _bf(xs)
    return xs.to(_BF16), skip


@functools.lru_cache(maxsize=None)
def _layer_fn():
    lib = load_library().cdll
    fn = lib.pwg_stack_layer
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.pwg_stack_error_string.argtypes = [ctypes.c_int]
    lib.pwg_stack_error_string.restype = ctypes.c_char_p
    return fn, lib.pwg_stack_error_string


def _check(name: str, a: torch.Tensor, shape, dtype, device) -> None:
    if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device != device or not a.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def _fused_residual_stack_cuda(x, c, weights, dilations, stacks):
    b, t, cr = x.shape
    ca = c.shape[-1]
    n = len(dilations)
    if c.shape[:2] != (b, t):
        raise ValueError(f"c {tuple(c.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not fused_stack_supported(cr, 2 * cr, cr, 3, n, stacks, ca):
        raise ValueError(f"K1 does not support cr={cr}, ca={ca}, "
                         f"layers={n}, stacks={stacks}")
    if not 0 < b <= 65535 or t <= 0:
        raise ValueError(f"K1 needs 1 <= B <= 65535 and T >= 1, got "
                         f"B={b}, T={t}")
    dev = x.device
    wg, wso, bso = pack_stack_weights(weights, cr, ca)
    kp = 3 * cr + _aux_width(ca)
    _check("wg", wg, (n, kp, 2 * cr), _BF16, dev)
    _check("wso", wso, (n, cr, 2 * cr), _BF16, dev)
    _check("bso", bso, (n, 2 * cr), _F32, dev)
    fn, err_str = _layer_fn()
    per = n // stacks
    with torch.cuda.device(dev):
        x_cur = x.to(_BF16).to(_F32).contiguous()   # enters as bf16
        x_nxt = torch.empty_like(x_cur)
        c16 = c.to(_BF16).contiguous()
        skip = torch.empty((b, t, cr), dtype=_F32, device=dev)
        out = torch.empty((b, t, cr), dtype=_BF16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, d in enumerate(dilations):
            last = i == n - 1
            err = fn(x_cur.data_ptr(), None if last else x_nxt.data_ptr(),
                     out.data_ptr() if last else None, c16.data_ptr(),
                     wg[i].data_ptr(), wso[i].data_ptr(), bso[i].data_ptr(),
                     skip.data_ptr(), b, t, cr, ca, kp, int(d), int(i == 0),
                     int((i + 1) % per == 0), stream)
            if err != 0:
                raise RuntimeError(f"pwg_stack_layer (layer {i}) failed: "
                                   f"{err_str(err).decode()} ({err})")
            fused_residual_stack.launches += 1
            x_cur, x_nxt = x_nxt, x_cur
    return out, skip


def fused_residual_stack(x, c, weights, *, dilations: Sequence[int],
                         stacks: int):
    """K1: the kernel on CUDA tensors, its plain version on CPU tensors.

    Returns (x_final (B, T, cr) bf16, skip_sum (B, T, cr) float32), the
    skip sum before the generator's sqrt(1 / L) scale.
    """
    if x.device.type == "cpu" and c.device.type == "cpu":
        return fused_residual_stack_reference(x, c, weights,
                                              dilations=dilations,
                                              stacks=stacks)
    if not (x.is_cuda and c.is_cuda):
        raise ValueError(f"fused_residual_stack: x on {x.device}, c on "
                         f"{c.device}; both must be CUDA or both CPU")
    return _fused_residual_stack_cuda(x, c, weights, dilations, stacks)


fused_residual_stack.launches = 0   # kernel launches, one per layer
