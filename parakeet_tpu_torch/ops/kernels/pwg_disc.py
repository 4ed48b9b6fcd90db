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
``fused_disc_backward.launches``: ``k3b_launches``, a pass per layer and
with weight gradients one reduction;
``fused_disc_backward_recompute.launches``: ``k3c_launches``, K3c and with
weight gradients one reduction) or raise; on CPU tensors they run
``disc_forward_reference`` / ``disc_backward_reference`` /
``disc_backward_recompute_reference``, the plain statements of the same
arithmetic: bf16 products with float32 accumulation, float32 biases,
logits and gradients, bf16(dpre) as the operand of the backward products
and float32 dpre for db.  The geometry of the kernels (``forward_strips``,
``forward_window_rows``, ``k3a_grid``, ``k3a_smem_bytes``, ``k3b_chunks``,
``k3b_smem_bytes``, ``k3c_smem_bytes``) and the bytes they move
(``k3a_bytes``, ``k3b_bytes``, ``k3c_bytes``, ``k3c_buffer_bytes``) are
plain functions.

One difference from the TPU kernels: the gradient is zeroed outside
[0, T) before every layer, which makes it the exact transpose of the
forward; the Pallas kernels let it leak through the rows past the
signal's ends into the last ~37 rows of each end (ROADMAP queue 3).
"""
from __future__ import annotations

import ctypes
import functools
import statistics
from typing import Sequence

import torch

from ..geometry import time_shift
from .pwg_stack import _bf, check_launch, check_tensor, kernel_call

__all__ = ["fused_disc_tail", "fused_disc_supported", "DISC_TAIL_DILS",
           "VJP_MODES", "pack_disc_weights", "fused_disc_forward",
           "fused_disc_backward", "fused_disc_backward_recompute",
           "disc_forward_reference", "disc_backward_reference",
           "disc_backward_recompute_reference", "k3b_launches",
           "k3c_launches", "forward_strips", "forward_window_rows",
           "k3a_grid", "k3a_blocks_per_sm", "k3a_smem_bytes", "k3a_bytes",
           "k3b_chunks", "k3b_smem_bytes", "k3c_smem_bytes", "k3b_bytes",
           "k3c_bytes", "k3c_blocks", "k3c_buffer_bytes",
           "time_disc_backward_passes",
           "K3A_TILE_ROWS", "K3A_HALO", "K3B_TILE_ROWS", "K3C_TILE_ROWS",
           "K3C_REBUILD_FIRST"]

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
_LAYER_ARGS = (_P,) * 7 + (_I,) * 5 + (_FL, _P)
_REDUCE_ARGS = (_P, _P, _I, ctypes.c_longlong, _P)
_RC_ARGS = (_P,) * 8 + (_I, _I, _I, _FL, _P)
_RC_BLOCKS_ARGS = (_I, _I, _I)
# which pass of K3b each launch belongs to (``time_disc_backward_passes``)
_K3B_PASS = {"pwg_disc_bwd_layer": "layers", "pwg_reduce_partials": "reduce"}

# pwg_disc.cu's geometry.  K3a: centre rows a block, halo rows on each
# side (the receptive field, the sum of the dilations); K3b: rows a tile
# (tiles never cross an item), cp.async stages, halo rows on each side of
# a stage (the largest dilation); K3c: centre rows a tile, the reverse
# window's halo and the recompute window's.  A layer's partial holds dW's
# 192 rows, then db.
K3A_TILE_ROWS, K3A_HALO = 400, sum(DISC_TAIL_DILS)
K3B_TILE_ROWS, K3B_STAGES, _M = 64, 4, 8
K3C_TILE_ROWS, _H, _HR = 272, 40, 80
# K3c's recompute window: row r is time t0 - 80 + r, and the rebuilt
# streams are wanted on the reverse window, rows 40 .. 40 + TCR + 79
K3C_REBUILD_FIRST = _HR - _H
_PR = 3 * _C + 1
_LD = _C + 8             # bf16 pitch of weights and forward windows
_LDX = 80                # bf16 pitch of K3c's reverse windows
_WARPS = 8


def forward_strips(rows: int, first: int):
    """The strips the forward-layer routine computes (pwg_disc.cu's
    ``forward_layer``), so that window rows [first, first + rows) of x_8,
    the output of layer 7, are exact: for layers j = 0..7, (first window
    row, number of 16-row strips).  Layer j's output must be exact on
    those rows plus, on each side, the dilations of layers j + 1..7."""
    out = []
    for j in range(_NL - 1):
        ahead = sum(DISC_TAIL_DILS[j + 1:_NL - 1])
        out.append((first - ahead, -(-(rows + 2 * ahead) // 16)))
    return out


def forward_window_rows(rows: int, first: int) -> int:
    """Rows of a forward window (pwg_disc.cu's ``window_rows``): one past
    the last row the layers of ``forward_strips`` read (a layer's last
    strip may overrun the rows it must keep exact)."""
    return max(lo + 16 * n + DISC_TAIL_DILS[j]
               for j, (lo, n) in enumerate(forward_strips(rows, first)))


def _k3a_window():
    """K3a's window: rows RF - 1 .. RF + TC of x_8 are wanted (the centre
    and the output conv's taps); row r is time t0 - RF + r."""
    return K3A_TILE_ROWS + 2, K3A_HALO - 1


def k3a_grid(b: int, t: int) -> int:
    """K3a's blocks: one for each TC = 400 centre rows of an item (an
    item's last may be short)."""
    return b * -(-t // K3A_TILE_ROWS)


def k3a_blocks_per_sm() -> int:
    """K3a's resident blocks an SM, from the card's occupancy calculator
    (builds the kernels; raises without them)."""
    n = kernel_call("pwg_disc_fwd_blocks_per_sm", ())()
    if n < 1:
        raise RuntimeError(f"pwg_disc_fwd_blocks_per_sm returned {n}")
    return n


def k3b_launches(need_dx: bool = True, need_weights: bool = True) -> int:
    """Kernel launches of one K3b call: a pass per layer, and with the
    weight gradients one reduction of the chunks' partials (none when
    nothing is asked for)."""
    if not (need_dx or need_weights):
        return 0
    return _NL + int(need_weights)


def k3c_launches(need_dx: bool = True, need_weights: bool = True) -> int:
    """Kernel launches of one K3c call: the kernel, and with the weight
    gradients one reduction of the blocks' partials."""
    if not (need_dx or need_weights):
        return 0
    return 1 + int(need_weights)


def k3b_chunks(b: int, t: int, sms: int):
    """(chunks, tiles per chunk): each K3b pass cuts the B * ceil(T / 64)
    tiles of K3B_TILE_ROWS rows of one item, in (item, time) order, into
    at most ``sms`` contiguous chunks, one a block; each chunk's partials
    are added in chunk order."""
    tiles = b * -(-t // K3B_TILE_ROWS)
    per = -(-tiles // sms)
    return -(-tiles // per), per


def k3b_smem_bytes() -> int:
    """Dynamic shared memory of a K3b pass's block, as pwg_disc.cu's
    kLayerSmem: the layer's (192, 64) weights, K3B_STAGES stages of the
    tile's dpre and saved rows with their halo (pitch 72 bf16) and
    dlogits (float32), and the db sums."""
    xs = K3B_TILE_ROWS + 2 * _M
    stage = 2 * 2 * xs * _LD + 4 * xs
    return 2 * 3 * _C * _LD + K3B_STAGES * stage + 4 * (4 * _C
                                                         + K3B_TILE_ROWS)


def k3a_smem_bytes() -> int:
    """Dynamic shared memory of a K3a block, as pwg_disc.cu's kFwdSmem:
    two windows of ``forward_window_rows`` rows (pitch 72 bf16) and two
    layers' weights (the next arrives while one computes), the second
    window and weights giving way before the first layer to the float32
    window (64 float32 a row) where it is larger, then the nine layers'
    biases in float32."""
    rows, w = forward_window_rows(*_k3a_window()), 2 * 3 * _C * _LD
    return 2 * rows * _LD + w + max(4 * rows * _C, 2 * rows * _LD + w) + (
        4 * _NL * _C)


def k3c_smem_bytes() -> int:
    """Dynamic shared memory of a K3c block, as pwg_disc.cu's kRcSmem: the
    larger of the recompute half's (two windows of ``forward_window_rows``
    rows of pitch 72, two layers' weights, the biases of layers 0..7) and
    the reverse half's (two windows of TCR + 2 * 40 rows and their
    margins, two layers' weights, the dW operand's TCR + 16 rows), then
    the db sums."""
    tcr, w = K3C_TILE_ROWS, 2 * 3 * _C * _LD
    rows = forward_window_rows(tcr + 2 * _H, K3C_REBUILD_FIRST)
    fwd = 2 * 2 * rows * _LD + 2 * w + 4 * (_NL - 1) * _C
    rev = (2 * 2 * (tcr + 2 * _H + 2 * _M) * _LDX + 2 * w
           + 2 * (tcr + 2 * _M) * _LD)
    return max(fwd, rev) + 4 * (_WARPS + _NL) * _C


def k3a_bytes(b: int, t: int, save: bool = True) -> int:
    """Device-memory bytes of one K3a call on float32 h, counted from the
    shapes, each operand read once and each result written once: h in
    float32, the logits and, with ``save``, the nine bf16 streams; the
    weights and biases once.  (Each block also reads its halo rows, which
    its neighbours read too: about 1.2x h's rows at B=8, T=25,500.)"""
    rows = b * t
    return (rows * (4 * _C + 4 + _NL * 2 * _C * int(save))
            + _NL * (2 * 3 * _C * _C + 4 * _C))


def k3b_bytes(b: int, t: int, need_weights: bool = True,
              need_dx: bool = True, sms: int = 132):
    """Device-memory bytes of one K3b call, counted from the shapes, each
    operand read once and each result written once: {"layers": the nine
    passes, "reduce": the reduction, with the weight gradients}.  Pass 8
    reads dlogits and x_8 and writes dpre_7; passes 7..1 read dpre_j and
    x_j and write dpre_j-1 (384 bytes a row); pass 0 reads dpre_0 (and
    x_0 for dW) and writes dh; each chunk writes its partials."""
    rows = b * t
    stream = 2 * _C * rows
    layers = 4 * rows + 2 * stream + (_NL - 2) * 3 * stream + stream
    layers += stream * int(need_weights) + 4 * _C * rows * int(need_dx)
    layers += _NL * 2 * 3 * _C * _C              # the weights, once
    if not need_weights:
        return {"layers": layers}
    part = _NL * _PR * _C * 4
    chunks = k3b_chunks(b, t, sms)[0]
    return {"layers": layers + chunks * part,
            "reduce": chunks * part + part}


def k3c_blocks(b: int, t: int, sms: int) -> int:
    """K3c's persistent blocks: one an SM, no more than there are tiles
    (pwg_disc.cu's pwg_disc_rc_blocks)."""
    return min(b * -(-t // K3C_TILE_ROWS), sms)


def k3c_buffer_bytes(b: int, t: int, sms: int = 132):
    """Device memory K3c keeps per call beside its inputs and outputs:
    {"partials": each block's (9, 193, 64) float32 dW and db, "scratch":
    each block's nine rebuilt streams on the reverse window (TCR + 80
    rows, bf16)}."""
    blocks = k3c_blocks(b, t, sms)
    return {"partials": blocks * _NL * _PR * _C * 4,
            "scratch": blocks * _NL * (K3C_TILE_ROWS + 2 * _H) * _C * 2}


def k3c_bytes(b: int, t: int, need_weights: bool = True, sms: int = 132):
    """Bytes one K3c call moves between the SMs and L2, counted from the
    shapes and the tiles: {"kernel": h and dlogits in, dh out, per tile
    the nine streams' reverse-window rows written to the scratch and read
    back (the dW operand's TCR + 16 rows of each stream, the masks'
    TCR + 80 rows of streams 1..8) and the partials' read-modify-write,
    "reduce": the reduction}.  Whether the scratch and partials stay in
    L2 decides how much of it reaches HBM."""
    rows, tcr = b * t, K3C_TILE_ROWS
    tiles = b * -(-t // tcr)
    blocks = k3c_blocks(b, t, sms)
    row = 2 * _C                                 # a bf16 stream row
    wr = tcr + 2 * _H
    per_tile = _NL * wr * row + (_NL - 1) * wr * row
    kernel = rows * (2 * _C + 4 + 4 * _C) + tiles * per_tile
    kernel += 2 * _NL * 2 * 3 * _C * _C * blocks   # weights, per block
    if not need_weights:
        return {"kernel": kernel}
    dw = _NL * 3 * _C * _C * 4
    kernel += tiles * (_NL * (tcr + 2 * _M) * row + 2 * dw) - blocks * dw
    kernel += blocks * _NL * _C * 4                # db rows
    part = _NL * _PR * _C * 4
    return {"kernel": kernel, "reduce": blocks * part + part}


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
        wk16 = wk.to(_BF16).contiguous()
        bk32 = bk.to(_F32).contiguous()
        check_tensor("wk", wk16, (_NL, 3, _C, _C), _BF16, dev)
        check_tensor("bk", bk32, (_NL, _C), _F32, dev)
        logits = torch.empty((b, t), dtype=_F32, device=dev)
        saved = (torch.empty((_NL, b, t, _C), dtype=_BF16, device=dev)
                 if save else None)
        h32 = h.to(_F32).contiguous()   # the kernel rounds it to bf16
        fn = kernel_call("pwg_disc_fwd", _FWD_ARGS)
        check_launch("pwg_disc_fwd", fn(
            h32.data_ptr(), wk16.data_ptr(), bk32.data_ptr(),
            logits.data_ptr(), None if saved is None else saved.data_ptr(),
            b, t, float(slope), torch.cuda.current_stream(dev).cuda_stream))
        fused_disc_forward.launches += 1
        fused_disc_forward.saves += int(save)
    return logits, saved


fused_disc_forward.launches = 0
fused_disc_forward.saves = 0        # the launches that saved the inputs


def _ptr(a):
    return None if a is None else a.data_ptr()


def _split_partials(out):
    """The reduced (9, 193, 64) partials -> dW (9, 3, 64, 64), db (9, 64)."""
    return out[:, :3 * _C].reshape(_NL, 3, _C, _C), out[:, 3 * _C]


def _disc_backward_cuda(saved, dlog, wk, slope, need_dx, need_weights, sms,
                        timer=None):
    """K3b's launches on the current stream: the nine layer passes, last
    to first, dpre ping-ponging between two bf16 streams, then the
    reduction of the chunks' partials.  ``timer(pass, call)``, if given,
    wraps each launch (``time_disc_backward_passes``)."""
    _, b, t, _ = saved.shape
    dev = saved.device
    check_tensor("saved", saved, (_NL, b, t, _C), _BF16, dev)
    dl = dlog.to(_F32).reshape(b, t).contiguous()
    wkt = wk.to(_BF16).transpose(2, 3).reshape(_NL, 3 * _C, _C).contiguous()
    nchunk, per = k3b_chunks(b, t, sms)
    dx = (torch.empty((b, t, _C), dtype=_F32, device=dev)
          if need_dx else None)
    bufs = [torch.empty((b, t, _C), dtype=_BF16, device=dev)
            for _ in range(2)]
    part = (torch.empty((nchunk, _NL, _PR, _C), dtype=_F32, device=dev)
            if need_weights else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    layer = kernel_call("pwg_disc_bwd_layer", _LAYER_ARGS)
    reduce = kernel_call("pwg_reduce_partials", _REDUCE_ARGS)

    def run(name, fn, *args):
        call = (lambda: fn(*args))
        check_launch(name, call() if timer is None
                     else timer(_K3B_PASS[name], call))
        fused_disc_backward.launches += 1

    # layer j's operands by address: no tensor views on the launch path
    x0, w0 = saved.data_ptr(), wkt.data_ptr()
    dp = [a.data_ptr() for a in bufs]
    x_bytes, w_bytes = 2 * b * t * _C, 2 * 3 * _C * _C
    for j in range(_NL - 1, -1, -1):
        top = j == _NL - 1
        run("pwg_disc_bwd_layer", layer,
            x0 + j * x_bytes if j > 0 or need_weights else None,
            None if top else dp[(_NL - j) % 2],
            dl.data_ptr() if top else None, w0 + j * w_bytes,
            dp[(_NL - 1 - j) % 2] if j > 0 else None,
            _ptr(dx) if j == 0 else None, _ptr(part), j, b, t, nchunk, per,
            float(slope), stream)
    if not need_weights:
        return dx, None, None
    out = torch.empty((_NL, _PR, _C), dtype=_F32, device=dev)
    run("pwg_reduce_partials", reduce, part.data_ptr(), out.data_ptr(),
        nchunk, out.numel(), stream)
    return (dx, *_split_partials(out))


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_disc_backward(saved, dlog, wk, *, slope: float, need_dx: bool,
                        need_weights: bool):
    """K3b: (dh or None, dwk or None, dbk or None), float32.  The kernels
    on CUDA tensors (``k3b_launches``), ``disc_backward_reference`` on CPU
    tensors."""
    if saved.device.type == "cpu":
        dh, dwk, dbk = disc_backward_reference(saved, dlog, wk, slope=slope)
        return (dh if need_dx else None,
                dwk if need_weights else None,
                dbk if need_weights else None)
    if not (saved.is_cuda and dlog.is_cuda):
        raise ValueError("fused_disc_backward: saved on "
                         f"{saved.device}, dlog on {dlog.device}")
    if not (need_dx or need_weights):
        return None, None, None
    with torch.cuda.device(saved.device):
        return _disc_backward_cuda(saved, dlog, wk, slope, need_dx,
                                   need_weights, _sm_count(saved.device))


fused_disc_backward.launches = 0


def time_disc_backward_passes(saved, dlog, wk, *, slope: float,
                              reps: int = 10, warmup: int = 2):
    """Median milliseconds of K3b's passes in a call with dh and the
    weight gradients, from CUDA events around each launch: {"layers": the
    nine layer passes summed, "reduce": the reduction}."""
    totals = []
    with torch.cuda.device(saved.device):
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

            _disc_backward_cuda(saved, dlog, wk, slope, True, True,
                                _sm_count(saved.device), timer=timer)
            torch.cuda.synchronize()
            if rep >= warmup:
                ms = dict.fromkeys(_K3B_PASS.values(), 0.0)
                for kind, start, stop in events:
                    ms[kind] += start.elapsed_time(stop)
                totals.append(ms)
    return {k: statistics.median(m[k] for m in totals) for k in totals[0]}


def fused_disc_backward_recompute(h, dlog, wk, bk, *, slope: float,
                                  need_dx: bool, need_weights: bool):
    """K3c: (dh or None, dwk or None, dbk or None), float32, from the
    layer-0 output h and dlogits alone.  The kernel on CUDA tensors
    (``k3c_launches``), ``disc_backward_recompute_reference`` on CPU
    tensors."""
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
    counter = fused_disc_backward_recompute
    with torch.cuda.device(dev):
        h16 = h.to(_BF16).contiguous()
        dl = dlog.to(_F32).reshape(b, t).contiguous()
        wk16 = wk.to(_BF16).contiguous()
        wkt = wk16.transpose(2, 3).reshape(_NL, 3 * _C, _C).contiguous()
        bk32 = bk.to(_F32).contiguous()
        check_tensor("wk", wk16, (_NL, 3, _C, _C), _BF16, dev)
        check_tensor("bk", bk32, (_NL, _C), _F32, dev)
        nblk = kernel_call("pwg_disc_rc_blocks", _RC_BLOCKS_ARGS)(
            b, t, _sm_count(dev))
        per_block = kernel_call("pwg_disc_rc_scratch_elems", ())()
        scratch = torch.empty((nblk, per_block), dtype=_BF16, device=dev)
        dx = (torch.empty((b, t, _C), dtype=_F32, device=dev)
              if need_dx else None)
        part = (torch.empty((nblk, _NL, _PR, _C), dtype=_F32, device=dev)
                if need_weights else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = kernel_call("pwg_disc_bwd_rc", _RC_ARGS)
        check_launch("pwg_disc_bwd_rc", fn(
            h16.data_ptr(), dl.data_ptr(), wk16.data_ptr(), wkt.data_ptr(),
            bk32.data_ptr(), _ptr(dx), scratch.data_ptr(), _ptr(part), b, t,
            nblk, float(slope), stream))
        counter.launches += 1
        if not need_weights:
            return dx, None, None
        out = torch.empty((_NL, _PR, _C), dtype=_F32, device=dev)
        check_launch("pwg_reduce_partials", kernel_call(
            "pwg_reduce_partials", _REDUCE_ARGS)(
            part.data_ptr(), out.data_ptr(), nblk, out.numel(), stream))
        counter.launches += 1
    return (dx, *_split_partials(out))


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
