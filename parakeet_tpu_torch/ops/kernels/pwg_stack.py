"""Fused Parallel WaveGAN residual stack, forward (kernels K1 and K2a).

Counterpart of ``parakeet_tpu/ops/pallas/pwg_stack.py``:

- ``fused_residual_stack`` (K1, the Pallas ``_group_kernel``), with the
  same signature and contract: x (B, T, cr) and c (B, T, ca) plus the
  stacked (L, ...) weight-norm-folded weights of ``ResidualStack`` give
  ``(x_final (B, T, cr) bf16, skip_sum (B, T, cr) float32)``.
- ``fused_group_forward_save`` (K2a, the Pallas ``_group_save_kernel``):
  one group of layers, float32 in and out, that also returns each layer's
  input rows as bf16 for the backward (``pwg_stack_train.py``).

On CUDA tensors both launch the hand-written kernels or raise: at residual
widths 32 and 64 ``parakeet_tpu_torch/csrc/pwg_stack.cu``, one launch per
layer; at 128 ``csrc/pwg_stack_cr128.cu``, two (``k1_layer_launches``): a
gate kernel split over two blocks by halves of the gate's column pairs,
which writes h, and an output kernel, whose weights fit beside it no more.
``fused_residual_stack.launches`` and ``fused_group_forward_save.launches``
count those launches.  On CPU tensors they run ``group_forward_reference``,
the plain PyTorch statement of the same arithmetic.

K1's launches sit behind a registered PyTorch operator,
``torch.ops.parakeet_tpu_torch.pwg_residual_stack`` (CUDA only, with a
fake kernel that states its outputs' shapes and types), so that
``torch.export`` can trace a vocoder that holds it (its fake tensors have
no addresses to hand to the launcher): the weights' packing and the bf16
casts stay ordinary operators in front of it, and an exported program
runs K1 through the operator.  Loading such a program needs this module
imported first (it registers the operator).  The launcher's geometry is
stated as plain functions: ``k1_warps`` and ``k1_smem_bytes`` (a block's
warps and shared memory; at 128 the gate launch's, and
``K1_OUT_SMEM`` the output launch's) and ``k1_layer_bytes`` (the bytes its
launches must move).

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import time_shift
from ._build import load_library

__all__ = ["fused_residual_stack", "fused_residual_stack_reference",
           "fused_group_forward_save", "group_forward_reference",
           "fused_stack_supported", "pack_stack_weights", "check_tensor",
           "kernel_call", "aux_rows", "k1_warps", "k1_smem_bytes",
           "k1_layer_bytes", "k1_layer_launches", "K1_OUT_SMEM",
           "SMEM_LIMIT", "pwg_residual_stack", "K1_OP"]

_SQRT_HALF = math.sqrt(0.5)
_F32, _BF16 = torch.float32, torch.bfloat16
# the most dynamic shared memory a block may have on the H100 (227 KB)
SMEM_LIMIT = 232_448
K1_MAX_WARPS = 8        # pwg_stack.cu's MAX_WARPS
# the residual width whose layers are two launches (pwg_stack_cr128.cu)
K1_SPLIT_WIDTH = 128
# shared memory of pwg_stack_cr128.cu's output launch: wso in bf16 rows of
# 2cr + 8, bso, and eight warps' stages of 16 rows of h (rows of cr + 8)
K1_OUT_SMEM = (2 * K1_SPLIT_WIDTH * (2 * K1_SPLIT_WIDTH + 8)
               + 4 * 2 * K1_SPLIT_WIDTH + 8 * 16 * 2 * (K1_SPLIT_WIDTH + 8))


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
    # the kernels' instances: one launch a layer at 32 and 64, two at 128
    # (pwg_stack_cr128.cu), where a layer's weights outgrow one block
    return residual_channels in (32, 64, K1_SPLIT_WIDTH)


def _aux_width(ca: int) -> int:
    """Columns of [c | 1 | zeros] in the gate operand: ca + 1 rounded up
    to the tensor-core depth of 16."""
    return -(-(ca + 1) // 16) * 16


def pack_stack_weights(weights: Dict[str, torch.Tensor], cr: int, ca: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stacked effective weights -> the kernel's operands, in float32 and
    differentiable (the training path keeps the packing in autograd).

    ``weights``: conv (L, 3, cr, 2cr), aux (L, ca, 2cr), skip and out
    (L, cr, cr), optional conv_b (L, 2cr), skip_b and out_b (L, cr).
    Returns wg (L, 3cr + _aux_width(ca), 2cr) whose rows are
    [tap t-d | tap t+d | center tap | aux | gate bias | zeros], wso
    (L, cr, 2cr) = [W_skip | W_out], and bso (L, 2cr) = [b_skip | b_out].
    The kernels take wg and wso in bf16.
    """
    conv = weights["conv"].to(_F32)
    n = conv.shape[0]
    zero_row = conv.new_zeros((n, 1, 2 * cr))
    bias = (zero_row if weights.get("conv_b") is None
            else weights["conv_b"].to(_F32)[:, None])
    pad = conv.new_zeros((n, _aux_width(ca) - ca - 1, 2 * cr))
    wg = torch.cat([conv[:, 0], conv[:, 2], conv[:, 1],
                    weights["aux"].to(_F32), bias, pad], dim=1)
    wso = torch.cat([weights["skip"], weights["out"]], dim=2).to(_F32)
    if weights.get("skip_b") is None:
        bso = conv.new_zeros((n, 2 * cr))
    else:
        bso = torch.cat([weights["skip_b"], weights["out_b"]], dim=1).to(_F32)
    return wg, wso, bso


def _bf(a: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return float32 (exact products in a f32 matmul)."""
    return a.to(_BF16).to(_F32)


def group_operand(xb: torch.Tensor, aux: torch.Tensor, d: int
                  ) -> torch.Tensor:
    """The gate operand [x(t-d) | x(t+d) | x(t) | c | 1 | 0] of one layer,
    from its bf16-valued input xb (float32) and aux = [c | 1 | 0]."""
    return torch.cat([time_shift(xb, -d), time_shift(xb, d), xb, aux], -1)


def aux_operand(c: torch.Tensor, kp: int, cr: int) -> torch.Tensor:
    """[bf16(c) | 1 | 0 ...] as float32, kp - 3cr columns."""
    b, t, ca = c.shape
    ones = torch.ones((b, t, 1), dtype=_F32, device=c.device)
    zeros = torch.zeros((b, t, kp - 3 * cr - ca - 1), dtype=_F32,
                        device=c.device)
    return torch.cat([_bf(c), ones, zeros], dim=-1)


def aux_rows(c16: torch.Tensor, kp: int, cr: int):
    """c as the kernels read the gate operand's aux columns, and its
    width: c16 itself where its rows are 16-byte vectors (ca % 8 == 0; the
    kernels add the 1 and the zeros), else the bf16 [c | 1 | 0] of
    ``aux_operand`` (kp - 3cr columns), built once per call."""
    ca = c16.shape[-1]
    if ca % 8 == 0:
        return c16, ca
    return aux_operand(c16, kp, cr).to(_BF16).contiguous(), kp - 3 * cr


def _k1_smem(cr: int, ca: int, warps: int) -> int:
    aw = _aux_width(ca)
    if cr == K1_SPLIT_WIDTH:
        # the gate launch: its half of wg's columns; a stage of 16 bf16
        # rows of the whole gate operand
        kp = 3 * cr + aw
        return 2 * kp * (cr + 8) + warps * 16 * 2 * (kp + 8)
    weights = 2 * (3 * cr + aw + cr) * (2 * cr + 8) + 4 * 2 * cr
    stage = 16 * (4 * (3 * cr + 8) + 2 * (aw + 8))
    return weights + warps * stage


def k1_layer_launches(cr: int) -> int:
    """Kernel launches a layer of K1 or K2a: one, or two at cr 128 (the
    gate launch, then the output launch)."""
    return 2 if cr == K1_SPLIT_WIDTH else 1


def k1_warps(cr: int, ca: int) -> int:
    """Warps of a K1/K2a block, as pwg_stack.cu's ``Geometry::warps``
    picks them: 8, or as many 16-row stages as fit beside the weights (7
    at cr 64 with ca >= 96).  Each warp walks its own tiles of 16 rows.
    At cr 128 the gate launch's (pwg_stack_cr128.cu's ``GateGeometry``: 6
    at ca 80); its output launch has 8."""
    return max(w for w in range(1, K1_MAX_WARPS + 1)
               if w == 1 or _k1_smem(cr, ca, w) <= SMEM_LIMIT)


def k1_smem_bytes(cr: int, ca: int) -> int:
    """Dynamic shared memory of a K1/K2a block, as pwg_stack.cu's
    ``Geometry`` counts it: wg and wso in bf16 rows of 2cr + 8 and bso in
    float32, resident; a stage a warp of 16 rows of float32 taps (rows of
    3cr + 8) and bf16 [c | 1 | 0] columns (rows of its width + 8).  At cr
    128 the gate launch's: its half of wg in rows of cr + 8 and a stage a
    warp of 16 rows of the bf16 gate operand [taps | c | 1 | 0] (rows of
    KP + 8); the output launch's is ``K1_OUT_SMEM``."""
    return _k1_smem(cr, ca, k1_warps(cr, ca))


def k1_layer_bytes(b: int, t: int, cr: int, ca: int, layers: int,
                   stacks: int, save: bool) -> int:
    """Device-memory bytes that the launches of ``layers`` layers must
    move, counted from the shapes with one layer per launch: each layer
    reads x in float32 once (its shifted taps are the same rows), c as
    the kernel reads it (``aux_rows``) and the skip sum, and writes the
    skip sum and x_next.  At cr 128 a layer's two launches read x's taps
    in bf16 (written by the previous layer, or the caller), write and read
    h in bf16, read x in float32 in the output launch and write x_next in
    bf16 too (in K2a as the next layer's saved rows).  ``save``:
    ``stacks`` calls of ``fused_group_forward_save`` (K2a), each of which
    starts its skip sum (no read in its first layer), writes each layer's
    bf16 input rows and ends in float32; else one ``fused_residual_stack``
    call (K1), which starts the skip sum once and writes its last x in
    bf16.  The weights (read once a block, from L2) are left out."""
    rows = b * t
    cw = ca if ca % 8 == 0 else _aux_width(ca)
    per_layer = cr * 4 + cw * 2 + 2 * cr * 4 + cr * 4 + (cr * 2 if save
                                                          else 0)
    if cr == K1_SPLIT_WIDTH:
        per_layer += -cr * 2 + 2 * cr * 2 + cr * 4 + (0 if save else cr * 2)
    starts = stacks if save else 1
    last_bf16 = 0 if save else cr * 2
    # at cr 128 the last layer of a call writes no bf16 copy of x_next
    last_copy = starts * cr * 2 if cr == K1_SPLIT_WIDTH else 0
    return rows * (layers * per_layer - starts * cr * 4 - last_bf16
                   - last_copy)


def group_forward_reference(x, c, wg, wso, bso, *, dilations: Sequence[int],
                            save: bool = True):
    """Plain PyTorch version of one group of K1/K2a layers.

    x (B, T, cr) and c (B, T, ca) enter as bf16; wg, wso, bso are the
    packed (Lg, ...) weights.  Returns (x_next (B, T, cr) float32 holding
    bf16 values, skip (B, T, cr) float32, saved) where saved is the
    (Lg, B, T, cr) bf16 stack of each layer's input, or None.  Every
    product is ``bf16.float() @ bf16.float()``, so the result does not
    depend on how a backend accumulates bf16.
    """
    cr = x.shape[-1]
    wg32, wso32 = _bf(wg), _bf(wso)
    aux = aux_operand(c, wg.shape[1], cr)
    xs = _bf(x)
    skip, saved = None, []
    for i, d in enumerate(dilations):
        xb = _bf(xs)
        if save:
            saved.append(xb.to(_BF16))
        g = group_operand(xb, aux, d) @ wg32[i]
        h = _bf(torch.tanh(g[..., :cr]) * torch.sigmoid(g[..., cr:]))
        so = h @ wso32[i] + bso[i].to(_F32)
        skip = so[..., :cr] if skip is None else skip + so[..., :cr]
        xs = (so[..., cr:] + xs) * _SQRT_HALF
    return _bf(xs), skip, (torch.stack(saved) if save else None)


def fused_residual_stack_reference(x, c, weights, *,
                                   dilations: Sequence[int], stacks: int):
    """Plain PyTorch version of K1: the groups of
    ``group_forward_reference`` in a row."""
    cr, ca = x.shape[-1], c.shape[-1]
    wg, wso, bso = pack_stack_weights(weights, cr, ca)
    per = wg.shape[0] // stacks
    xs, skip = x, None
    for g in range(stacks):
        sl = slice(g * per, (g + 1) * per)
        xs, sk, _ = group_forward_reference(
            xs, c, wg[sl], wso[sl], bso[sl], dilations=dilations[sl],
            save=False)
        skip = sk if skip is None else skip + sk
    return xs.to(_BF16), skip


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library().cdll
    lib.pwg_stack_error_string.argtypes = [ctypes.c_int]
    lib.pwg_stack_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel_call(name: str, argtypes: Tuple):
    """The library's C function ``name`` with its ctypes signature."""
    fn = getattr(_lib(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# cudaErrorStreamCaptureUnsupported (900) .. cudaErrorStreamCaptureWrongThread
# (908): the stream capture, not the launch, failed
_CAPTURE_ERRORS = range(900, 909)


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned an error code; an error of the CUDA graph
    capture the launch was recorded into is reported as the capture's."""
    if err == 0:
        return
    what = f"{_lib().pwg_stack_error_string(err).decode()} ({err})"
    if err in _CAPTURE_ERRORS:
        raise RuntimeError(f"CUDA graph capture failed when {name} was "
                           f"recorded into it: {what}; the kernel did not "
                           "fail, the capture did")
    raise RuntimeError(f"{name} failed: {what}")


def check_tensor(name: str, a: torch.Tensor, shape, dtype, device) -> None:
    if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device != device or not a.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_LAYER_ARGS = (_P,) * 9 + (_I,) * 9 + (_P,)
_GATE_ARGS = (_P,) * 4 + (_I,) * 7 + (_P,)     # pwg_stack_layer_gate
_OUT_ARGS = (_P,) * 8 + (_I,) * 5 + (_P,)      # pwg_stack_layer_out


def _check_stack_args(x, c, n, stacks, what):
    b, t, cr = x.shape
    ca = c.shape[-1]
    if c.shape[:2] != (b, t):
        raise ValueError(f"c {tuple(c.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not fused_stack_supported(cr, 2 * cr, cr, 3, n, stacks, ca):
        raise ValueError(f"{what} does not support cr={cr}, ca={ca}, "
                         f"layers={n}, stacks={stacks}")
    if not 0 < b <= 65535 or t <= 0:
        raise ValueError(f"{what} needs 1 <= B <= 65535 and T >= 1, got "
                         f"B={b}, T={t}")


def _run_layers(x_cur, c16, wg16, wso16, bso, dilations, *, per, out,
                saved, counter, x16=None):
    """One launch per layer (two at cr 128: ``_run_split_layer``) from
    float32 x_cur (overwritten: the layers ping-pong between it and a
    buffer of their own); the last layer writes ``out`` (bf16 to end the
    stack, float32 to end a group).  At cr 128 the gate launches read
    each layer's input in bf16: the first layer's from ``x16`` (K1) or,
    with ``saved`` (K2a), from ``saved[0]``, which this fills with x_cur;
    the output launches write the next layer's (into ``saved[i + 1]``, or
    in place in a buffer of their own)."""
    b, t, cr = x_cur.shape
    ca = c16.shape[-1]
    kp = wg16.shape[1]
    c_op, cw = aux_rows(c16, kp, cr)
    x_nxt = torch.empty_like(x_cur)
    skip = torch.empty((b, t, cr), dtype=_F32, device=x_cur.device)
    split = cr == K1_SPLIT_WIDTH
    if split:
        h = torch.empty((b, t, cr), dtype=_BF16, device=x_cur.device)
        if saved is not None:
            saved[0].copy_(x_cur)       # bf16 values: exact
            xb = saved[0]
        else:
            xb, xb_next = x16, torch.empty_like(h)
    else:
        fn = kernel_call("pwg_stack_layer", _LAYER_ARGS)
    stream = torch.cuda.current_stream(x_cur.device).cuda_stream
    n = len(dilations)
    for i, d in enumerate(dilations):
        last = i == n - 1
        dst = out if last else x_nxt
        bf16_out = dst.dtype == _BF16
        x_f32 = None if bf16_out else dst.data_ptr()
        x_bf16 = dst.data_ptr() if bf16_out else None
        starts, ends = int(i == 0), int((i + 1) % per == 0)
        if split:
            xb_out = None if last else (
                saved[i + 1] if saved is not None else xb_next)
            _run_split_layer(x_cur, xb, c_op, wg16[i], h, x_f32, x_bf16,
                             xb_out, wso16[i], bso[i], skip, b, t, cr, ca,
                             cw, kp, int(d), starts, ends, stream, i, counter)
            xb = xb_out
        else:
            err = fn(x_cur.data_ptr(), x_f32, x_bf16, c_op.data_ptr(),
                     wg16[i].data_ptr(), wso16[i].data_ptr(),
                     bso[i].data_ptr(), skip.data_ptr(),
                     None if saved is None else saved[i].data_ptr(), b, t,
                     cr, ca, cw, kp, int(d), starts, ends, stream)
            check_launch(f"pwg_stack_layer (layer {i})", err)
            counter.launches += 1
        if not last:
            x_cur, x_nxt = x_nxt, x_cur
    return skip


def _run_split_layer(x_cur, xb, c_op, wg, h, x_f32, x_bf16, xb_out, wso,
                     bso, skip, b, t, cr, ca, cw, kp, d, starts, ends, stream,
                     i, counter):
    """A layer at cr 128 (pwg_stack_cr128.cu): the gate launch reads the
    layer's bf16 input ``xb`` and writes h, the output launch reads h and
    x_cur and writes x_next (and in bf16 into ``xb_out`` unless None); each
    adds one to ``counter``."""
    err = kernel_call("pwg_stack_layer_gate", _GATE_ARGS)(
        xb.data_ptr(), c_op.data_ptr(), wg.data_ptr(), h.data_ptr(), b, t,
        cr, ca, cw, kp, d, stream)
    check_launch(f"pwg_stack_layer_gate (layer {i})", err)
    counter.launches += 1
    err = kernel_call("pwg_stack_layer_out", _OUT_ARGS)(
        h.data_ptr(), x_cur.data_ptr(), x_f32, x_bf16,
        None if xb_out is None else xb_out.data_ptr(), wso.data_ptr(),
        bso.data_ptr(), skip.data_ptr(), b, t, cr, starts, ends, stream)
    check_launch(f"pwg_stack_layer_out (layer {i})", err)
    counter.launches += 1


K1_OP = "parakeet_tpu_torch::pwg_residual_stack"


@torch.library.custom_op(
    K1_OP, mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor c, Tensor wg, Tensor wso, Tensor bso, "
           "int[] dilations, int stacks) -> (Tensor, Tensor)")
def pwg_residual_stack(x: torch.Tensor, c: torch.Tensor, wg: torch.Tensor,
                       wso: torch.Tensor, bso: torch.Tensor,
                       dilations: List[int], stacks: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's launches as a registered operator, CUDA tensors only: x (B, T,
    cr) and c (B, T, ca) bf16, wg (L, KP, 2cr) and wso (L, cr, 2cr) bf16
    and bso (L, 2cr) float32 as ``pack_stack_weights`` packs them.
    Returns (x_final bf16, skip_sum float32), (B, T, cr) each; advances
    ``fused_residual_stack.launches`` once a launch (``k1_layer_launches``
    a layer)."""
    b, t, cr = x.shape
    n = len(dilations)
    dev = x.device
    kp = 3 * cr + _aux_width(c.shape[-1])
    check_tensor("x", x, (b, t, cr), _BF16, dev)
    check_tensor("c", c, (b, t, c.shape[-1]), _BF16, dev)
    check_tensor("wg", wg, (n, kp, 2 * cr), _BF16, dev)
    check_tensor("wso", wso, (n, cr, 2 * cr), _BF16, dev)
    check_tensor("bso", bso, (n, 2 * cr), _F32, dev)
    with torch.cuda.device(dev):
        x_cur = x.to(_F32)          # a buffer of the op's own
        out = torch.empty((b, t, cr), dtype=_BF16, device=dev)
        skip = _run_layers(x_cur, c, wg, wso, bso, dilations,
                           per=n // stacks, out=out, saved=None,
                           counter=fused_residual_stack, x16=x)
    return out, skip


@pwg_residual_stack.register_fake
def _pwg_residual_stack_fake(x, c, wg, wso, bso, dilations, stacks):
    return (x.new_empty(x.shape, dtype=_BF16),
            x.new_empty(x.shape, dtype=_F32))


def _fused_residual_stack_cuda(x, c, weights, dilations, stacks):
    """The operands of ``pwg_residual_stack`` from x, c and the stacked
    weights (ordinary operators, which ``torch.export`` keeps in front of
    the op), then the op."""
    cr, ca = x.shape[-1], c.shape[-1]
    _check_stack_args(x, c, len(dilations), stacks, "K1")
    wg, wso, bso = pack_stack_weights(weights, cr, ca)
    return pwg_residual_stack(x.to(_BF16).contiguous(),
                              c.to(_BF16).contiguous(),
                              wg.to(_BF16).contiguous(),
                              wso.to(_BF16).contiguous(), bso.contiguous(),
                              [int(d) for d in dilations], int(stacks))


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


fused_residual_stack.launches = 0   # kernel launches (k1_layer_launches)


def fused_group_forward_save(x, c16, wg16, wso16, bso, *,
                             dilations: Sequence[int]):
    """K2a: one group of layers that saves each layer's input.

    x: (B, T, cr) float32 (rounded to bf16 on entry); c16: (B, T, ca)
    bf16; wg16 (Lg, KP, 2cr) and wso16 (Lg, cr, 2cr) bf16, bso (Lg, 2cr)
    float32, as ``pack_stack_weights`` packs them.  Returns (x_next
    float32 holding bf16 values, skip float32, saved (Lg, B, T, cr) bf16).
    The kernel on CUDA tensors, ``group_forward_reference`` on CPU ones.
    """
    if x.device.type == "cpu" and c16.device.type == "cpu":
        return group_forward_reference(x, c16, wg16, wso16, bso,
                                       dilations=dilations)
    if not (x.is_cuda and c16.is_cuda):
        raise ValueError(f"fused_group_forward_save: x on {x.device}, c "
                         f"on {c16.device}; both must be CUDA or both CPU")
    b, t, cr = x.shape
    n = len(dilations)
    _check_stack_args(x, c16, n, 1, "K2a")
    dev = x.device
    kp = 3 * cr + _aux_width(c16.shape[-1])
    check_tensor("c", c16, c16.shape, _BF16, dev)
    check_tensor("wg", wg16, (n, kp, 2 * cr), _BF16, dev)
    check_tensor("wso", wso16, (n, cr, 2 * cr), _BF16, dev)
    check_tensor("bso", bso, (n, 2 * cr), _F32, dev)
    with torch.cuda.device(dev):
        x_cur = x.to(_BF16).to(_F32).contiguous()
        out = torch.empty((b, t, cr), dtype=_F32, device=dev)
        saved = torch.empty((n, b, t, cr), dtype=_BF16, device=dev)
        skip = _run_layers(x_cur, c16, wg16, wso16, bso, dilations,
                           per=n, out=out, saved=saved,
                           counter=fused_group_forward_save)
    return out, skip, saved


fused_group_forward_save.launches = 0   # launches (k1_layer_launches)
