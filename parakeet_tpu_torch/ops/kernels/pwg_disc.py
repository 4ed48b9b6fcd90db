"""Fused Parallel WaveGAN discriminator, layers 1..9 (kernels K3a, K3b,
K3c).

Counterpart of ``parakeet_tpu/ops/pallas/pwg_disc.py::fused_disc_tail``:
eight 64 -> 64 k=3 convs with dilations 1..8, each followed by LeakyReLU,
then the 64 -> 1 output conv (its weight padded to 64 columns), on the
layer-0 output h (B, T, 64).  The forward (K3a) keeps each layer's input
in bf16.  Two backwards, as the JAX ``vjp_mode``:

- 'save': K3a saves every layer's input under autograd, and K3b takes the
  LeakyReLU mask from the sign of the saved next input and returns dh, dW
  and db;
- 'recompute': K3a runs without saving, and K3c rebuilds the layer inputs
  from h inside the backward, then runs K3b's arithmetic on them.  dh
  equals the save path's; dW and db differ in the order of their sums.

On CUDA tensors they launch the kernels of
``parakeet_tpu_torch/csrc/pwg_disc.cu`` (``fused_disc_forward.launches``:
one per forward, ``.saves`` of them with saving;
``fused_disc_backward.launches``: the reverse pass, and
with weight gradients their pass and two reductions;
``fused_disc_backward_recompute.launches``: K3c, and with weight
gradients two reductions) or raise; on CPU tensors they run
``disc_forward_reference`` / ``disc_backward_reference`` /
``disc_backward_recompute_reference``, the plain statements of the same
arithmetic: bf16 products with float32 accumulation, float32 biases,
logits and gradients, bf16(dpre) as the operand of the backward products
and float32 dpre for db.

One difference from the TPU kernels: the gradient is zeroed outside
[0, T) before every layer, which makes it the exact transpose of the
forward; the Pallas kernels let it leak through the rows past the
signal's ends into the last ~37 rows of each end (ROADMAP queue 3).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..geometry import time_shift
from .pwg_stack import _bf, check_launch, check_tensor, kernel_call

__all__ = ["fused_disc_tail", "fused_disc_supported", "DISC_TAIL_DILS",
           "VJP_MODES", "pack_disc_weights", "fused_disc_forward",
           "fused_disc_backward", "fused_disc_backward_recompute",
           "disc_forward_reference", "disc_backward_reference",
           "disc_backward_recompute_reference"]

_TK = 64            # rows per step of the dW kernel (pwg_disc.cu TK)


def dw_chunks(rows: int, device: torch.device):
    """(chunks, rows per chunk) of a weight-gradient pass: one chunk per
    SM, each a multiple of the kernel's 64-row step."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-rows // sms)
    per = -(-per // _TK) * _TK
    return -(-rows // per), per


# layers 1..8 (dilation = layer index) + the k=3 d=1 output conv
DISC_TAIL_DILS = (1, 2, 3, 4, 5, 6, 7, 8, 1)
_NL = len(DISC_TAIL_DILS)
VJP_MODES = ("save", "recompute")
_C = 64
_F32, _BF16 = torch.float32, torch.bfloat16


def fused_disc_supported(in_channels: int, out_channels: int,
                         kernel_size: int, layers: int,
                         conv_channels: int, dilation_factor: int) -> bool:
    return (in_channels == 1 and out_channels == 1 and kernel_size == 3
            and layers == 10 and conv_channels == _C
            and dilation_factor == 1)


def pack_disc_weights(kernels: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor]):
    """9 effective (3, 64, cout) kernels and (cout,) biases (cout 64, the
    last 1) -> wk (9, 3, 64, 64) and bk (9, 64) float32, differentiable;
    the last layer is padded with zero columns."""
    wks, bks = [], []
    for ker, bias in zip(kernels, biases):
        pad = _C - ker.shape[-1]
        wks.append(torch.nn.functional.pad(ker.to(_F32), (0, pad)))
        bks.append(torch.nn.functional.pad(bias.to(_F32), (0, pad)))
    return torch.stack(wks), torch.stack(bks)


def disc_forward_reference(h, wk, bk, *, slope: float, save: bool = True):
    """Plain PyTorch version of K3a.  h (B, T, 64) enters as bf16.
    Returns (logits (B, T) float32, saved (9, B, T, 64) bf16 or None)."""
    w = _bf(wk)
    x = _bf(h)
    saved = []
    for j, d in enumerate(DISC_TAIL_DILS):
        if save:
            saved.append(x.to(_BF16))
        pre = (time_shift(x, -d) @ w[j, 0] + x @ w[j, 1]
               + time_shift(x, d) @ w[j, 2] + bk[j].to(_F32))
        if j < _NL - 1:
            x = _bf(torch.where(pre > 0, pre, slope * pre))
    return pre[..., 0], (torch.stack(saved) if save else None)


def disc_backward_reference(saved, dlog, wk, *, slope: float):
    """Plain PyTorch version of K3b, written out after the Pallas
    ``_bwd_kernel``.  saved (9, B, T, 64) bf16, dlog (B, T) float32.
    Returns (dh (B, T, 64), dwk (9, 3, 64, 64), dbk (9, 64)), float32."""
    w = _bf(wk)
    dy = torch.zeros(saved.shape[1:], dtype=_F32, device=saved.device)
    dy[..., 0] = dlog.to(_F32)
    dwk = torch.zeros_like(w)
    dbk = torch.zeros((_NL, _C), dtype=_F32, device=saved.device)
    for j in range(_NL - 1, -1, -1):
        d = DISC_TAIL_DILS[j]
        if j < _NL - 1:
            sg = torch.sign(saved[j + 1].to(_F32))
            dpre = dy * (0.5 * (1.0 + slope) + 0.5 * (1.0 - slope) * sg)
        else:
            dpre = dy
        dbk[j] = dpre.sum((0, 1))
        p = _bf(dpre)
        x = saved[j].to(_F32)
        for tap, off in enumerate((-d, 0, d)):
            dwk[j, tap] = torch.einsum("btk,btn->kn", time_shift(x, off), p)
        dy = (time_shift(p @ w[j, 0].T, d) + p @ w[j, 1].T
              + time_shift(p @ w[j, 2].T, -d))
    return dy, dwk, dbk


def disc_backward_recompute_reference(h, dlog, wk, bk, *, slope: float):
    """Plain PyTorch version of K3c: the layer inputs rebuilt from h by
    ``disc_forward_reference``, then ``disc_backward_reference``.
    Returns (dh (B, T, 64), dwk (9, 3, 64, 64), dbk (9, 64)), float32."""
    _, saved = disc_forward_reference(h, wk, bk, slope=slope, save=True)
    return disc_backward_reference(saved, dlog, wk, slope=slope)


_P, _I, _FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_P,) * 5 + (_I, _I, _FL, _P)
_BWD_ARGS = (_P,) * 6 + (_I, _I, _FL, _P)
_DW_ARGS = (_P,) * 3 + (_I,) * 4 + (_P,)
_BLOCKS_ARGS = (_I, _I)
_REDUCE_ARGS = (_P, _P, _I, ctypes.c_longlong, _P)
_RC_ARGS = (_P,) * 9 + (_I, _I, _I, _FL, _P)
_RC_BLOCKS_ARGS = (_I, _I, _I)


def _check_shape(b: int, t: int) -> None:
    if b <= 0 or t <= 0 or b * t > 2 ** 30:
        raise ValueError(f"the fused discriminator needs B, T >= 1 and "
                         f"B * T <= 2^30, got B={b}, T={t}")


def fused_disc_forward(h, wk, bk, *, slope: float, save: bool):
    """K3a: (logits (B, T) float32, saved (9, B, T, 64) bf16 or None).
    The kernel on CUDA tensors, its plain version on CPU tensors."""
    if h.device.type == "cpu":
        return disc_forward_reference(h, wk, bk, slope=slope, save=save)
    if not h.is_cuda:
        raise ValueError(f"fused_disc_forward: h on {h.device}")
    b, t, c = h.shape
    if c != _C:
        raise ValueError(f"fused_disc_forward: h has {c} channels, not 64")
    _check_shape(b, t)
    dev = h.device
    with torch.cuda.device(dev):
        h16 = h.to(_BF16).contiguous()
        wk16 = wk.to(_BF16).contiguous()
        bk32 = bk.to(_F32).contiguous()
        check_tensor("wk", wk16, (_NL, 3, _C, _C), _BF16, dev)
        check_tensor("bk", bk32, (_NL, _C), _F32, dev)
        logits = torch.empty((b, t), dtype=_F32, device=dev)
        saved = (torch.empty((_NL, b, t, _C), dtype=_BF16, device=dev)
                 if save else None)
        fn = kernel_call("pwg_disc_fwd", _FWD_ARGS)
        check_launch("pwg_disc_fwd", fn(
            h16.data_ptr(), wk16.data_ptr(), bk32.data_ptr(),
            logits.data_ptr(), None if saved is None else saved.data_ptr(),
            b, t, float(slope), torch.cuda.current_stream(dev).cuda_stream))
        fused_disc_forward.launches += 1
        fused_disc_forward.saves += int(save)
    return logits, saved


fused_disc_forward.launches = 0
fused_disc_forward.saves = 0        # the launches that saved the inputs


def fused_disc_backward(saved, dlog, wk, *, slope: float, need_dx: bool,
                        need_weights: bool):
    """K3b: (dh or None, dwk or None, dbk or None), float32.  The kernels
    on CUDA tensors, ``disc_backward_reference`` on CPU tensors."""
    if saved.device.type == "cpu":
        dh, dwk, dbk = disc_backward_reference(saved, dlog, wk, slope=slope)
        return (dh if need_dx else None,
                dwk if need_weights else None,
                dbk if need_weights else None)
    if not (saved.is_cuda and dlog.is_cuda):
        raise ValueError("fused_disc_backward: saved on "
                         f"{saved.device}, dlog on {dlog.device}")
    _, b, t, _ = saved.shape
    dev = saved.device
    counter = fused_disc_backward
    with torch.cuda.device(dev):
        check_tensor("saved", saved, (_NL, b, t, _C), _BF16, dev)
        dl = dlog.to(_F32).reshape(b, t).contiguous()
        wkt = wk.to(_BF16).transpose(2, 3).reshape(_NL, 3 * _C, _C)
        wkt = wkt.contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        dx = (torch.empty((b, t, _C), dtype=_F32, device=dev)
              if need_dx else None)
        dpre = dbp = None
        if need_weights:
            nblk = kernel_call("pwg_disc_blocks", _BLOCKS_ARGS)(b, t)
            dpre = torch.empty((_NL, b, t, _C), dtype=_BF16, device=dev)
            dbp = torch.empty((nblk, _NL, _C), dtype=_F32, device=dev)
        fn = kernel_call("pwg_disc_bwd", _BWD_ARGS)
        check_launch("pwg_disc_bwd", fn(
            saved.data_ptr(), dl.data_ptr(), wkt.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if dpre is None else dpre.data_ptr(),
            None if dbp is None else dbp.data_ptr(), b, t, float(slope),
            stream))
        counter.launches += 1
        if not need_weights:
            return dx, None, None
        nchunk, chunk_rows = dw_chunks(b * t, dev)
        part = torch.empty((nchunk, _NL, 3 * _C, _C), dtype=_F32,
                           device=dev)
        check_launch("pwg_disc_dw", kernel_call("pwg_disc_dw", _DW_ARGS)(
            saved.data_ptr(), dpre.data_ptr(), part.data_ptr(), b, t,
            nchunk, chunk_rows, stream))
        counter.launches += 1
        reduce = kernel_call("pwg_reduce_partials", _REDUCE_ARGS)
        dwk = torch.empty((_NL, 3, _C, _C), dtype=_F32, device=dev)
        dbk = torch.empty((_NL, _C), dtype=_F32, device=dev)
        check_launch("pwg_reduce_partials", reduce(
            part.data_ptr(), dwk.data_ptr(), nchunk, dwk.numel(), stream))
        check_launch("pwg_reduce_partials", reduce(
            dbp.data_ptr(), dbk.data_ptr(), nblk, dbk.numel(), stream))
        counter.launches += 2
    return dx, dwk, dbk


fused_disc_backward.launches = 0


def fused_disc_backward_recompute(h, dlog, wk, bk, *, slope: float,
                                  need_dx: bool, need_weights: bool):
    """K3c: (dh or None, dwk or None, dbk or None), float32, from the
    layer-0 output h and dlogits alone.  The kernel on CUDA tensors,
    ``disc_backward_recompute_reference`` on CPU tensors."""
    if not (need_dx or need_weights):
        raise ValueError("fused_disc_backward_recompute: nothing to compute")
    if h.device.type == "cpu":
        dh, dwk, dbk = disc_backward_recompute_reference(h, dlog, wk, bk,
                                                         slope=slope)
        return (dh if need_dx else None,
                dwk if need_weights else None,
                dbk if need_weights else None)
    if not (h.is_cuda and dlog.is_cuda):
        raise ValueError("fused_disc_backward_recompute: h on "
                         f"{h.device}, dlog on {dlog.device}")
    b, t, c = h.shape
    if c != _C:
        raise ValueError(f"fused_disc_backward_recompute: h has {c} "
                         "channels, not 64")
    _check_shape(b, t)
    dev = h.device
    with torch.cuda.device(dev):
        h16 = h.to(_BF16).contiguous()
        dl = dlog.to(_F32).reshape(b, t).contiguous()
        wk16 = wk.to(_BF16).contiguous()
        wkt = wk16.transpose(2, 3).reshape(_NL, 3 * _C, _C).contiguous()
        bk32 = bk.to(_F32).contiguous()
        check_tensor("wk", wk16, (_NL, 3, _C, _C), _BF16, dev)
        check_tensor("bk", bk32, (_NL, _C), _F32, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nblk = kernel_call("pwg_disc_rc_blocks", _RC_BLOCKS_ARGS)(b, t, sms)
        per_block = kernel_call("pwg_disc_rc_scratch_elems", ())()
        scratch = torch.empty((nblk, per_block), dtype=_BF16, device=dev)
        dx = (torch.empty((b, t, _C), dtype=_F32, device=dev)
              if need_dx else None)
        part = dbp = None
        if need_weights:
            part = torch.empty((nblk, _NL, 3 * _C, _C), dtype=_F32,
                               device=dev)
            dbp = torch.empty((nblk, _NL, _C), dtype=_F32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = kernel_call("pwg_disc_bwd_rc", _RC_ARGS)
        check_launch("pwg_disc_bwd_rc", fn(
            h16.data_ptr(), dl.data_ptr(), wk16.data_ptr(), wkt.data_ptr(),
            bk32.data_ptr(), None if dx is None else dx.data_ptr(),
            scratch.data_ptr(), None if part is None else part.data_ptr(),
            None if dbp is None else dbp.data_ptr(), b, t, nblk,
            float(slope), stream))
        counter = fused_disc_backward_recompute
        counter.launches += 1
        if not need_weights:
            return dx, None, None
        reduce = kernel_call("pwg_reduce_partials", _REDUCE_ARGS)
        dwk = torch.empty((_NL, 3, _C, _C), dtype=_F32, device=dev)
        dbk = torch.empty((_NL, _C), dtype=_F32, device=dev)
        check_launch("pwg_reduce_partials", reduce(
            part.data_ptr(), dwk.data_ptr(), nblk, dwk.numel(), stream))
        check_launch("pwg_reduce_partials", reduce(
            dbp.data_ptr(), dbk.data_ptr(), nblk, dbk.numel(), stream))
        counter.launches += 2
    return dx, dwk, dbk


fused_disc_backward_recompute.launches = 0


class _DiscTail(torch.autograd.Function):
    """K3a with saving forward, K3b backward."""

    @staticmethod
    def forward(ctx, h, wk, bk, slope):
        logits, saved = fused_disc_forward(h, wk, bk, slope=slope, save=True)
        ctx.save_for_backward(saved, wk)
        ctx.slope = slope
        return logits

    @staticmethod
    def backward(ctx, dlog):
        saved, wk = ctx.saved_tensors
        need_w = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dh, dwk, dbk = fused_disc_backward(
            saved, dlog, wk, slope=ctx.slope,
            need_dx=ctx.needs_input_grad[0], need_weights=need_w)
        return dh, dwk, dbk, None


class _DiscTailRecompute(torch.autograd.Function):
    """K3a without saving forward, K3c backward: only h (in bf16, the form
    the kernels read) and the packed weights are kept for the backward."""

    @staticmethod
    def forward(ctx, h, wk, bk, slope):
        logits, _ = fused_disc_forward(h, wk, bk, slope=slope, save=False)
        ctx.save_for_backward(h.to(_BF16), wk, bk)
        ctx.slope = slope
        return logits

    @staticmethod
    def backward(ctx, dlog):
        h16, wk, bk = ctx.saved_tensors
        need_w = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dh, dwk, dbk = fused_disc_backward_recompute(
            h16, dlog, wk, bk, slope=ctx.slope,
            need_dx=ctx.needs_input_grad[0], need_weights=need_w)
        return dh, dwk, dbk, None


def fused_disc_tail(h, kernels, biases, *, negative_slope: float = 0.2,
                    vjp_mode: str = "save"):
    """Fused discriminator layers 1..9: h (B, T, 64), the layer-0 output;
    kernels/biases: the 9 effective (weight-norm-folded) (3, 64, cout)
    kernels and their biases.  Returns logits (B, T, 1) float32.
    Differentiable, through K3b (``vjp_mode='save'``) or K3c
    ('recompute'); without autograd it runs K3a without saving."""
    if vjp_mode not in VJP_MODES:
        raise ValueError(f"vjp_mode must be one of {VJP_MODES}, got "
                         f"{vjp_mode!r}")
    wk, bk = pack_disc_weights(kernels, biases)
    h = h.to(_F32)
    if torch.is_grad_enabled() and (h.requires_grad or wk.requires_grad
                                    or bk.requires_grad):
        fn = _DiscTail if vjp_mode == "save" else _DiscTailRecompute
        logits = fn.apply(h, wk, bk, float(negative_slope))
    else:
        logits, _ = fused_disc_forward(h, wk, bk, slope=negative_slope,
                                       save=False)
    return logits[..., None]
