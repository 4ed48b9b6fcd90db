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
``parakeet_tpu_torch/csrc/pwg_stack_bwd.cu`` (``k2b_launches``: a prep
pass, then gate, dw and dx per layer, and one reduction per group;
``fused_group_backward.launches`` counts them; the residual width 128's
instances build in ``csrc/pwg_stack_bwd_cr128.cu``, their passes split
over the grid's y by column blocks, ``k2b_splits``) or raises; on CPU
tensors it runs ``group_backward_reference``, the plain statement of the
same arithmetic.  The gradient is the exact transpose of
the bf16 forward, as on the TPU: dx, dh, da, db and dc stay float32 and
only the products' operands dso and dg are rounded to bf16.  The bf16
rounding of x at a group's entry and exit passes the gradient through.
"""
from __future__ import annotations

import ctypes
import math
import statistics
from typing import Dict, Sequence

import torch

from ..geometry import time_shift
from .pwg_stack import (SMEM_LIMIT, _aux_width, _bf, _check_stack_args,
                        aux_operand, aux_rows, check_launch, check_tensor,
                        fused_group_forward_save, group_operand, kernel_call,
                        pack_stack_weights)

__all__ = ["fused_residual_stack_train", "fused_group_backward",
           "group_backward_reference", "k2b_launches", "k2b_chunks",
           "k2b_parts", "k2b_splits", "k2b_smem_bytes", "k2b_pass_bytes",
           "aux_rows", "SMEM_LIMIT", "time_group_backward_passes"]

_SQRT_HALF = math.sqrt(0.5)
_F32, _BF16 = torch.float32, torch.bfloat16


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
_ARGS = {
    "pwg_stack_bwd_prep": (_P,) * 3 + (_I,) * 5 + (_P,),
    "pwg_stack_bwd_gate": (_P,) * 9 + (_I,) * 9 + (_LL, _P),
    "pwg_stack_bwd_dw": (_P,) * 4 + (_I,) * 9 + (_LL, _P),
    "pwg_stack_bwd_dx": (_P,) * 6 + (_I,) * 9 + (_P,),
    "pwg_reduce_partials": (_P, _P, _I, _LL, _P),
}
# which pass each launch belongs to (``time_group_backward_passes``)
_PASS = {"pwg_stack_bwd_prep": "prep", "pwg_stack_bwd_gate": "gate",
         "pwg_stack_bwd_dw": "dw", "pwg_stack_bwd_dx": "dx",
         "pwg_reduce_partials": "reduce"}

# pwg_stack_bwd.cu's geometry: rows per tile, threads per block, the
# stages of each pass's cp.async ring
K2B_TILE_ROWS, K2B_THREADS = 64, 256
_STAGES = {"gate": 2, "dw": 3, "dx": 2}


def k2b_splits(cr: int):
    """pwg_stack_bwd.cuh's split of each pass at residual width ``cr``:
    {pass: (blocks a chunk along the grid's y, rows a tile, stages)}.  At
    32 and 64 a chunk is one block of 64-row tiles; at 128 the gate takes
    the column pairs j in two halves and the dx pass dx's columns in two,
    both in tiles of 32 rows with one stage, and dw dg's columns in four."""
    if cr > 64:
        return {"gate": (2, 32, 1), "dw": (4, K2B_TILE_ROWS, 3),
                "dx": (2, 32, 1)}
    return {k: (1, K2B_TILE_ROWS, n) for k, n in _STAGES.items()}


def k2b_parts(cr: int, sms: int) -> int:
    """Chunks a K2b call cuts its rows into on a card of ``sms`` SMs: one a
    block (one an SM), and at cr 128, whose gate and dx passes run two
    blocks a chunk, one for each two SMs."""
    return max(1, sms // k2b_splits(cr)["gate"][0])


def k2b_launches(layers: int, need_weights: bool = True) -> int:
    """Kernel launches of K2b for one group of ``layers`` layers: the
    prep, then gate and dx per layer, with the weight gradients dw per
    layer and one reduction."""
    return 3 * layers + 2 if need_weights else 2 * layers + 1


def k2b_chunks(rows: int, sms: int):
    """(chunks, rows per chunk): every K2b pass gives each of at most
    ``sms`` blocks one contiguous chunk of the flattened rows, and each
    chunk's weight-gradient partials are added in chunk order."""
    per = -(-rows // sms)
    return -(-rows // per), per


def k2b_smem_bytes(cr: int, ca: int):
    """Dynamic shared memory of each K2b kernel a block (the prep kernel's
    4 KB are static), as pwg_stack_bwd.cuh computes it (``gate_elems``,
    ``dw_elems``, ``dx_elems``): the weights a block needs stay resident
    (at cr 128 its column block's, ``k2b_splits``), the streamed row tiles
    have their stages.  Rows are padded by 8 elements."""
    kp = 3 * cr + _aux_width(ca)
    cap = -(-ca // 16) * 16
    sp = k2b_splits(cr)
    z, tm, st = sp["gate"]
    jw = cr // z                          # the block's column pairs j
    gate = (kp * (2 * jw + 8) + jw * (2 * cr + 8) + st * tm * (kp + cr + 16)
            + tm * (cr + 8) + tm * (jw + 8))
    z, tm, st = sp["dw"]
    dw = st * tm * (kp + 8 + 2 * cr // z + 8)
    z, tm, st = sp["dx"]
    dx = (6 * cr * (cr // z + 8) + 2 * cr * (cap + 8)
          + st * 3 * tm * (2 * cr + 8))
    return {"prep": 16 * K2B_THREADS, "gate": 2 * gate, "dw": 2 * dw,
            "dx": 2 * dx}


def k2b_pass_bytes(b: int, t: int, cr: int, ca: int, layers: int,
                   chunks: int, need_weights: bool = True):
    """Device-memory bytes each K2b pass must move for one group, counted
    from the shapes: each operand read once and each result written once
    (the shifted taps are the same rows as the centre's), partials
    included.  Keys as ``time_group_backward_passes``."""
    rows = b * t
    kp = 3 * cr + _aux_width(ca)
    g = 2 * cr
    w = 1 if need_weights else 0
    prep = rows * cr * (4 + 2) + w * chunks * cr * 4
    gate = layers * (rows * (cr * 2 + ca * 2 + cr * 4 + cr * 2 + g * 2)
                     + w * chunks * (cr + 1) * g * 4)
    dx = layers * rows * (g * 2 + cr * 4 + cr * 4 + ca * 4) \
        + (layers - 1) * rows * ca * 4
    out = {"prep": prep, "gate": gate, "dx": dx}
    if need_weights:
        part = layers * (kp + cr + 1) * g * 4
        out["dw"] = layers * (rows * (cr * 2 + ca * 2 + g * 2)
                              + chunks * kp * g * 4)
        out["reduce"] = chunks * part + part
    return out


def _group_backward_cuda(saved, c16, wg16, wso16, dx_out, dskip, dilations,
                         need_weights, timer=None):
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
    fns = {name: kernel_call(name, args) for name, args in _ARGS.items()}

    def run(name, *args):
        call = (lambda: fns[name](*args))
        err = call() if timer is None else timer(_PASS[name], call)
        check_launch(name, err)
        counter.launches += 1

    with torch.cuda.device(dev):
        dxc = dx_out.to(_F32).contiguous()
        dsk = dskip.to(_F32).contiguous()
        check_tensor("dx_out", dxc, (b, t, cr), _F32, dev)
        check_tensor("dskip", dsk, (b, t, cr), _F32, dev)
        c_op, cw = aux_rows(c16, kp, cr)
        # dx's weights: the centre, t-d and t+d tap blocks of wg transposed;
        # dc's: Wa^T, padded to cap columns
        wdx = torch.cat([wg16[:, 2 * cr:3 * cr].transpose(1, 2),
                         wg16[:, :cr].transpose(1, 2),
                         wg16[:, cr:2 * cr].transpose(1, 2)], 1).contiguous()
        wdc = torch.zeros((n, 2 * cr, cap), dtype=_BF16, device=dev)
        wdc[:, :, :ca] = wg16[:, 3 * cr:3 * cr + ca].transpose(1, 2)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nparts, chunk = k2b_chunks(b * t, k2b_parts(cr, sms))
        dsk16 = torch.empty((b, t, cr), dtype=_BF16, device=dev)
        dg = torch.empty((b, t, 2 * cr), dtype=_BF16, device=dev)
        # two fresh buffers for the dx of successive layers: the caller's
        # dx_out is read, never written
        bufs = (torch.empty_like(dxc), torch.empty_like(dxc))
        dc = torch.empty((b, t, ca), dtype=_F32, device=dev)
        p = (kp + cr + 1) * 2 * cr          # one layer's partial block
        part = sk_part = None
        if need_weights:
            part = torch.empty((nparts, n, p), dtype=_F32, device=dev)
            sk_part = torch.empty((nparts, cr), dtype=_F32, device=dev)

        def ptr(a):
            return None if a is None else a.data_ptr()

        stream = torch.cuda.current_stream(dev).cuda_stream
        run("pwg_stack_bwd_prep", dsk.data_ptr(), dsk16.data_ptr(),
            ptr(sk_part), b, t, cr, nparts, chunk, stream)
        for k, j in enumerate(range(n - 1, -1, -1)):
            d = int(dilations[j])
            dx_nxt = bufs[k % 2]
            part_j = None if part is None else part[0, j].data_ptr()
            run("pwg_stack_bwd_gate", saved[j].data_ptr(), c_op.data_ptr(),
                wg16[j].data_ptr(), wso16[j].data_ptr(), dxc.data_ptr(),
                dsk16.data_ptr(), ptr(sk_part), dg.data_ptr(), part_j, b, t,
                cr, ca, cw, kp, d, nparts, chunk, n * p, stream)
            if need_weights:
                run("pwg_stack_bwd_dw", saved[j].data_ptr(), c_op.data_ptr(),
                    dg.data_ptr(), part_j, b, t, cr, ca, cw, kp, d, nparts,
                    chunk, n * p, stream)
            run("pwg_stack_bwd_dx", dg.data_ptr(), wdx[j].data_ptr(),
                wdc[j].data_ptr(), dxc.data_ptr(), dx_nxt.data_ptr(),
                dc.data_ptr(), b, t, cr, ca, cap, d, int(j == n - 1), nparts,
                chunk, stream)
            dxc = dx_nxt
        if not need_weights:
            return dxc, dc, None, None, None
        out = torch.empty((n, kp + cr + 1, 2 * cr), dtype=_F32, device=dev)
        run("pwg_reduce_partials", part.data_ptr(), out.data_ptr(), nparts,
            n * p, stream)
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


fused_group_backward.launches = 0   # every K2b launch (k2b_launches)


def time_group_backward_passes(saved, c16, wg16, wso16, dx_out, dskip, *,
                               dilations: Sequence[int], reps: int = 10,
                               warmup: int = 2):
    """Median milliseconds of each K2b pass over one group on the card,
    from CUDA events around each launch, summed over the group's
    launches of that pass: {"prep", "gate", "dw", "dx", "reduce"}."""
    totals = []
    for rep in range(warmup + reps):
        events = []

        def timer(kind, call):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            err = call()
            stop.record()
            events.append((kind, start, stop))
            return err

        _group_backward_cuda(saved, c16, wg16, wso16, dx_out, dskip,
                             dilations, True, timer=timer)
        torch.cuda.synchronize()
        if rep >= warmup:
            ms = dict.fromkeys(_PASS.values(), 0.0)
            for kind, start, stop in events:
                ms[kind] += start.elapsed_time(stop)
            totals.append(ms)
    return {k: statistics.median(m[k] for m in totals) for k in totals[0]}


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
