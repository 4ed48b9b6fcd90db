"""Differentiable fused Parallel WaveGAN residual stack (kernels K2a, K2b).

Counterpart of ``parakeet_tpu/ops/pallas/pwg_stack_train.py``: each group
of layers is a ``torch.autograd.Function`` whose forward is K2a
(``pwg_stack.fused_group_forward_save``: K1 that also saves each layer's
bf16 input) and whose backward is K2b (``fused_group_backward``, the
Pallas ``_bwd_kernel``): rebuild the gate from the saved rows, then dx,
dc and the gradients of the packed weights.  The weight-norm fold and the
packing stay in autograd.  Without autograd, or when nothing needs a
gradient, ``ResidualStack`` runs K1 instead.

On CUDA tensors the backward launches the kernels of
``parakeet_tpu_torch/csrc/pwg_stack_bwd.cu`` (three per layer and one
reduction per group; ``fused_group_backward.launches`` counts them) or
raises; on CPU tensors it runs ``group_backward_reference``, the plain
statement of the same arithmetic.  The gradient is the exact transpose of
the bf16 forward, as on the TPU: dx, dh, da, db and dc stay float32 and
only the products' operands dso and dg are rounded to bf16.  The bf16
rounding of x at a group's entry and exit passes the gradient through.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence

import torch

from ..geometry import time_shift
from .pwg_stack import (_bf, _check_stack_args, aux_operand,
                        check_launch, check_tensor, fused_group_forward_save,
                        group_operand, kernel_call, pack_stack_weights)

__all__ = ["fused_residual_stack_train", "fused_group_backward",
           "group_backward_reference"]

_SQRT_HALF = math.sqrt(0.5)
_F32, _BF16 = torch.float32, torch.bfloat16
_TK = 64            # rows per step of the dw kernel (pwg_stack_bwd.cu TK)


def group_backward_reference(saved, c, wg, wso, dx_out, dskip, *,
                             dilations: Sequence[int]):
    """Plain PyTorch version of K2b for one group, written out after the
    Pallas ``_bwd_kernel``.

    saved (Lg, B, T, cr) bf16 from the forward; c (B, T, ca); wg, wso the
    packed weights; dx_out and dskip the float32 gradients of the group's
    x_next and skip sum.  Returns (dx, dc, dwg, dwso, dbso), float32.
    """
    cr = dx_out.shape[-1]
    ca = c.shape[-1]
    kp = wg.shape[1]
    wg32, wso32 = _bf(wg), _bf(wso)
    aux = aux_operand(c, kp, cr)
    dskip = dskip.to(_F32)
    dxc = dx_out.to(_F32)
    dwg = torch.zeros_like(wg32)
    dwso = torch.zeros_like(wso32)
    dbso = torch.zeros((wg.shape[0], 2 * cr), dtype=_F32, device=c.device)
    dc = torch.zeros(c.shape, dtype=_F32, device=c.device)
    for j in range(len(dilations) - 1, -1, -1):
        d = dilations[j]
        a = group_operand(saved[j].to(_F32), aux, d)
        g = a @ wg32[j]                      # the gate, as in the forward
        ta = torch.tanh(g[..., :cr])
        sb = torch.sigmoid(g[..., cr:])
        h = _bf(ta * sb)
        dres = dxc * _SQRT_HALF
        dso = _bf(torch.cat([dskip, dres], -1))
        dh = dso @ wso32[j].T
        dg = _bf(torch.cat([dh * sb * (1.0 - ta * ta),
                            dh * ta * sb * (1.0 - sb)], -1))
        dwg[j] = torch.einsum("btk,btn->kn", a, dg)
        dwso[j] = torch.einsum("btk,btn->kn", h, dso)
        dbso[j] = torch.cat([dskip.sum((0, 1)), dres.sum((0, 1))])
        da = dg @ wg32[j].T                  # [d tap t-d | d tap t+d | ...]
        dxc = (da[..., 2 * cr:3 * cr] + time_shift(da[..., :cr], d)
               + time_shift(da[..., cr:2 * cr], -d) + dres)
        dc = dc + da[..., 3 * cr:3 * cr + ca]
    return dxc, dc, dwg, dwso, dbso


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATE_ARGS = (_P,) * 8 + (_I,) * 6 + (_P,)
_DX_ARGS = (_P,) * 6 + (_I,) * 7 + (_P,)
_DW_ARGS = (_P,) * 7 + (_I,) * 8 + (_LL, _P)
_REDUCE_ARGS = (_P, _P, _I, _LL, _P)


def dw_chunks(rows: int, device: torch.device):
    """(chunks, rows per chunk) of a weight-gradient pass: one chunk per
    SM, each a multiple of the kernel's 64-row step."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-rows // sms)
    per = -(-per // _TK) * _TK
    return -(-rows // per), per


def _group_backward_cuda(saved, c16, wg16, wso16, dx_out, dskip, dilations,
                         need_weights):
    n, b, t, cr = saved.shape
    ca = c16.shape[-1]
    kp = wg16.shape[1]
    dev = saved.device
    check_tensor("saved", saved, saved.shape, _BF16, dev)
    check_tensor("c", c16, (b, t, ca), _BF16, dev)
    check_tensor("wg", wg16, (n, kp, 2 * cr), _BF16, dev)
    check_tensor("wso", wso16, (n, cr, 2 * cr), _BF16, dev)
    cap = -(-ca // 16) * 16
    counter = fused_group_backward
    with torch.cuda.device(dev):
        dxc = dx_out.to(_F32).contiguous()
        dsk = dskip.to(_F32).contiguous()
        check_tensor("dx_out", dxc, (b, t, cr), _F32, dev)
        check_tensor("dskip", dsk, (b, t, cr), _F32, dev)
        # the products' weights: [W_skip | W_out]^T for dh, the centre,
        # t-d and t+d tap blocks of wg transposed for dx, Wa^T for dc
        wsot = wso16.transpose(1, 2).contiguous()
        wdx = torch.cat([wg16[:, 2 * cr:3 * cr].transpose(1, 2),
                         wg16[:, :cr].transpose(1, 2),
                         wg16[:, cr:2 * cr].transpose(1, 2)], 1).contiguous()
        wdc = torch.zeros((n, 2 * cr, cap), dtype=_BF16, device=dev)
        wdc[:, :, :ca] = wg16[:, 3 * cr:3 * cr + ca].transpose(1, 2)
        dg = torch.empty((b, t, 2 * cr), dtype=_BF16, device=dev)
        h = torch.empty((b, t, cr), dtype=_BF16, device=dev)
        # two fresh buffers for the dx of successive layers: the caller's
        # dx_out is read, never written
        bufs = (torch.empty_like(dxc), torch.empty_like(dxc))
        dc = torch.empty((b, t, ca), dtype=_F32, device=dev)
        p = (kp + cr + 1) * 2 * cr          # one layer's partial block
        if need_weights:
            nchunk, chunk_rows = dw_chunks(b * t, dev)
            part = torch.empty((nchunk, n, p), dtype=_F32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        gate = kernel_call("pwg_stack_bwd_gate", _GATE_ARGS)
        dxk = kernel_call("pwg_stack_bwd_dx", _DX_ARGS)
        dwk = kernel_call("pwg_stack_bwd_dw", _DW_ARGS)
        for k, j in enumerate(range(n - 1, -1, -1)):
            d = int(dilations[j])
            dx_nxt = bufs[k % 2]
            check_launch("pwg_stack_bwd_gate", gate(
                saved[j].data_ptr(), c16.data_ptr(), wg16[j].data_ptr(),
                wsot[j].data_ptr(), dxc.data_ptr(), dsk.data_ptr(),
                dg.data_ptr(), h.data_ptr(), b, t, cr, ca, kp, d, stream))
            counter.launches += 1
            if need_weights:
                check_launch("pwg_stack_bwd_dw", dwk(
                    saved[j].data_ptr(), c16.data_ptr(), dg.data_ptr(),
                    h.data_ptr(), dsk.data_ptr(), dxc.data_ptr(),
                    part[0, j].data_ptr(), b, t, cr, ca, kp, d, nchunk,
                    chunk_rows, n * p, stream))
                counter.launches += 1
            check_launch("pwg_stack_bwd_dx", dxk(
                dg.data_ptr(), wdx[j].data_ptr(), wdc[j].data_ptr(),
                dxc.data_ptr(), dx_nxt.data_ptr(), dc.data_ptr(), b, t, cr,
                ca, cap, d, int(j == n - 1), stream))
            counter.launches += 1
            dxc = dx_nxt
        if not need_weights:
            return dxc, dc, None, None, None
        out = torch.empty((n, kp + cr + 1, 2 * cr), dtype=_F32, device=dev)
        reduce = kernel_call("pwg_reduce_partials", _REDUCE_ARGS)
        check_launch("pwg_reduce_partials", reduce(
            part.data_ptr(), out.data_ptr(), nchunk, n * p, stream))
        counter.launches += 1
    return dxc, dc, out[:, :kp], out[:, kp:kp + cr], out[:, kp + cr]


def fused_group_backward(saved, c16, wg16, wso16, dx_out, dskip, *,
                         dilations: Sequence[int], need_weights: bool = True):
    """K2b: the backward of one group from K2a's saved rows.

    Returns (dx, dc, dwg, dwso, dbso) float32; the weight gradients are
    None when ``need_weights`` is false.  The kernels on CUDA tensors,
    ``group_backward_reference`` on CPU tensors.
    """
    if saved.device.type == "cpu":
        out = group_backward_reference(saved, c16, wg16, wso16, dx_out,
                                       dskip, dilations=dilations)
        return out if need_weights else out[:2] + (None, None, None)
    if not (saved.is_cuda and c16.is_cuda and dx_out.is_cuda):
        raise ValueError("fused_group_backward: tensors on "
                         f"{saved.device}, {c16.device}, {dx_out.device}; "
                         "all must be CUDA or all CPU")
    return _group_backward_cuda(saved, c16, wg16, wso16, dx_out, dskip,
                                dilations, need_weights)


fused_group_backward.launches = 0   # gate, dw and dx launches; reductions


class _StackGroup(torch.autograd.Function):
    """One group of layers: K2a forward, K2b backward.  Inputs and
    gradients are float32 (x between groups, c, the packed weights)."""

    @staticmethod
    def forward(ctx, x, c, wg, wso, bso, dilations):
        c16 = c.to(_BF16).contiguous()
        wg16 = wg.to(_BF16).contiguous()
        wso16 = wso.to(_BF16).contiguous()
        x_next, skip, saved = fused_group_forward_save(
            x, c16, wg16, wso16, bso.to(_F32).contiguous(),
            dilations=dilations)
        ctx.save_for_backward(saved, c16, wg16, wso16)
        ctx.dilations = dilations
        return x_next, skip

    @staticmethod
    def backward(ctx, dx_next, dskip):
        saved, c16, wg16, wso16 = ctx.saved_tensors
        need_w = any(ctx.needs_input_grad[2:5])
        dx, dc, dwg, dwso, dbso = fused_group_backward(
            saved, c16, wg16, wso16, dx_next, dskip,
            dilations=ctx.dilations, need_weights=need_w)
        return dx, dc, dwg, dwso, dbso, None


def fused_residual_stack_train(x, c, weights: Dict[str, torch.Tensor], *,
                               dilations: Sequence[int], stacks: int):
    """Differentiable twin of ``fused_residual_stack``.

    x: (B, T, cr), c: (B, T, ca), weights: the effective (weight-norm
    folded) stacked weights of ``ResidualStack``.  Returns (x_final
    float32 holding bf16 values, skip_sum float32).  The gradient stays
    float32 between groups.
    """
    cr, ca = x.shape[-1], c.shape[-1]
    n = len(dilations)
    if x.is_cuda:
        _check_stack_args(x, c, n, stacks, "K2")
    wg, wso, bso = pack_stack_weights(weights, cr, ca)
    per = n // stacks
    xs, skip = x.to(_F32), None
    c32 = c.to(_F32)
    for g in range(stacks):
        sl = slice(g * per, (g + 1) * per)
        xs, sk = _StackGroup.apply(xs, c32, wg[sl], wso[sl], bso[sl],
                                   tuple(dilations[sl]))
        skip = sk if skip is None else skip + sk
    return xs, skip
