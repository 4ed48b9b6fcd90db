"""Flash attention (kernel K4): forward (K4a), dK/dV pass (K4b), dQ pass
(K4c).

Counterpart of the Pallas TPU flash-attention kernel that
``parakeet_tpu/nn/flash.py::make_flash_attn_core`` wraps (jax's
``pallas/ops/tpu/flash_attention.py`` and its custom VJP).  Tensors are
(B, H, T, D), contiguous, all float32 or all bfloat16; the masks are
per-row validities ``q_valid`` (B, Tq) and ``kv_valid`` (B, Tk), and the
pair (i, j) is allowed iff ``q_valid[i] == kv_valid[j]`` (jax's segment
ids).  D is a multiple of 16 in [16, 1024]: the kernels have instances at
padded widths 32, 64, 96, 128, 192 (the FastSpeech2 recipes' adim 384
over 2 heads) and 256 (adim 512 over 2 heads), and a width between two
of them runs at the wider one with zero columns (``k4_padded_dim``);
above 256 (adim 384 over one head, 512 over one) the "wide" instances
take every width, padded to a multiple of 128 (``k4_padded_dim``).

On CUDA tensors the wrappers launch the kernels of
``parakeet_tpu_torch/csrc/flash_attn.cu`` (``flash_attention_forward``,
``flash_attention_dkv`` and ``flash_attention_dq``, each counting its
launches in ``.launches``) or raise; on CPU tensors they run the plain
versions below, which state the kernels' arithmetic:

- scores ``s = (q . k in float32) * sm_scale + where(allowed, 0,
  MASK_VALUE)``: the mask is *added*, as jax's kernel does (the dense core
  of ``MultiHeadAttention`` replaces masked scores by -1e9 instead; the
  two agree on every query row that may attend to some key, which is
  every real row of a key-padding mask).  A row that matches no key
  attends to all keys alike;
- ``m = max s``, ``l = sum exp(s - m)``, ``o = (sum T(exp(s - m)) v) *
  (1 / l)`` with ``1 / l`` replaced by 1 where l == 0, products summed in
  float32, ``T`` v's type (jax's rounding point for bf16), o cast to q's
  type; ``lse = m + log(l)`` (float32) is saved per row, where jax saves m
  and l broadcast to 128 lanes (a Mosaic layout).  K4a makes one pass over
  the keys, so it rounds p at each key tile's running max instead:
  ``flash_attention_reference(..., block_k=k4a_block_k(dtype, D))``
  states that (the same function; in bf16 p rounds at other points);
- backward, with ``di = sum(o * do)`` in float32 (a plain reduction, as
  jax computes it in XLA outside its kernels) and ``p = exp(s - lse)``
  (jax: ``exp(s - m) * (1 / l)``, equal up to float32 rounding):
  ``dv = T(p)^T do``, ``ds = ((do . v - di) * p) * sm_scale``, ``dk =
  T(ds)^T q``, ``dq = T(ds) k``, float32 sums, each cast to its input's
  type.

The three kernels are written for the H100 with ``mma.sync`` fragments
(the source's header has the details): each block owns 64 rows and
walks the other sequence in tiles double-buffered by ``cp.async`` (32
rows in float32; 64 in bf16, but 32 in the backward passes at D above
96 and in K4a at D = 256; 16 in the float32 backward passes at D = 256),
and the scores, p, dp and ds never leave registers.  K4a owns query rows
and makes one pass over the keys with the online softmax (at D = 192 and
256 with Q resident in shared memory); K4c owns query rows and streams
key tiles; K4b owns key rows and streams query tiles (at D = 192 and 256
two blocks of one launch share each 64 keys, one forming dV and one dK,
so that each holds one accumulator).  Above D = 256 K4a keeps nothing
resident: a block owns one chunk of 256 columns of O (the grid's z) and
forms each tile's scores over all of D in steps of 64 (float32) or 128
(bf16) columns of Q and K, then the product over its chunk.  K4b and
K4c run there as thread-block clusters, one a row block, of one block
for each chunk of at most 256 output columns (``k4_wide_split``): each
block keeps its columns of the row block's two operands resident,
streams tiles of its columns of the other two, forms the partial S and
dP over its columns (one warpgroup each), and the cluster adds the
partials in a fixed order through distributed shared memory, so that
every block holds the same S and dP, formed once; K4b's warpgroups then
form dV and dK, K4c's each half of dQ's columns.  ``k4_smem_bytes``
counts a block's shared memory as the kernels' geometry does.  The
backward passes use the final lse, so they round where the plain
versions do, and they have no atomics: two runs give bit-identical
gradients.  The kernels sum in
another order (and float32 products run as 3xTF32 splits), so they agree
with the plain versions to float32 rounding, and to a bf16 rounding of p
or ds in bf16.  Out-of-range rows are masked by the kernels themselves:
no caller pads T.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .pwg_stack import check_launch, kernel_call

__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_dkv", "flash_attention_dq",
           "flash_attention_reference", "flash_attention_dkv_reference",
           "flash_attention_dq_reference", "flash_head_dim_supported",
           "k4_padded_dim", "k4a_block_k", "k4_smem_bytes",
           "k4_wide_split", "k4_wide_bwd_attrs", "MASK_VALUE",
           "MAX_HEAD_DIM", "SMEM_LIMIT"]

# jax's DEFAULT_MASK_VALUE (-0.7 * float32 max, in float64) as float32
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
_F32, _BF16 = torch.float32, torch.bfloat16
# dynamic shared memory a block may have on the H100 (227 KB)
SMEM_LIMIT = 232448


# the widest head K4 takes (csrc/flash_attn.cu's kMaxD)
MAX_HEAD_DIM = 1024
# the most output columns a block of the wide K4b's and K4c's clusters
# owns (csrc/flash_attn.cuh's kWideW), and the most blocks a cluster may
# have (the portable cluster size)
WIDE_CHUNK, MAX_CLUSTER = 256, 8


def flash_head_dim_supported(dk: int) -> bool:
    """Head widths K4 takes: multiples of 16 in [16, 1024]."""
    return dk % 16 == 0 and 16 <= dk <= MAX_HEAD_DIM


def k4_padded_dim(dk: int) -> int:
    """The width of the kernel instance that runs head width ``dk`` (one
    ``flash_head_dim_supported`` takes), padded with zero columns: a
    multiple of 32 up to 128, then 192 or 256, then a multiple of 128
    (csrc/flash_attn.cu's ``padded_dim``; above 256 one wide instance
    takes every width)."""
    if dk <= 128:
        return -(-dk // 32) * 32
    if dk <= 256:
        return 192 if dk <= 192 else 256
    return -(-dk // 128) * 128


def k4a_block_k(dtype: torch.dtype, dk: int) -> int:
    """K4a's key tile at head width ``dk`` (``FwdGeo::BN`` and
    ``WideGeo::BN`` in csrc/flash_attn.cuh): 32 keys in float32, 64 in
    bf16 but 32 from the DP = 256 instances on.  The one-pass kernel
    rounds p at each tile's running max, which
    ``flash_attention_reference(..., block_k=k4a_block_k(dtype, dk))``
    states."""
    return 32 if dtype == _F32 or k4_padded_dim(dk) >= 256 else 64


def k4_smem_bytes(kernel: str, dtype: torch.dtype, dk: int) -> int:
    """Dynamic shared memory of a block of ``kernel`` ('K4a', 'K4b' or
    'K4c') at head width ``dk``, as csrc/flash_attn.cuh's ``FwdGeo`` and
    ``BwdGeo`` count it (and ``flash_attn_smem`` returns it): rows of
    pitch DP + 16 bytes; K4a Q resident above DP = 128, two stages of a K
    and a V tile and the tile's kv_valid; K4b and K4c two resident strips
    of 64 rows and two stages of two tiles and 3 (K4b) or 1 (K4c) vectors
    of 32-bit values.  Above DP = 256, the same at every width: K4a
    (``WideGeo``) two stages, each the larger of a chunk step's
    256-byte rows (64 of Q and 32 of K) and an out step's 32 rows of V
    over 256 columns, then kv_valid; K4b and K4c (``ClusterGeo``), a
    block of a cluster, rows of up to 256 columns at a pitch of 256 + 16
    bytes: two resident strips of 64 rows, two stages of two tiles of 16
    rows in float32 or 32 in bf16 and their vectors, then two slots of
    the S and dP partials, 64 by 16 or 32 float32 each."""
    dp = k4_padded_dim(dk)
    size = 4 if dtype == _F32 else 2
    nvec = {"K4a": 1, "K4b": 3, "K4c": 1}[kernel]
    if dp > 256 and kernel == "K4a":
        row = 256 + 16                           # a chunk step's pitch, bytes
        out = 32 * (256 + 16 // size) * size
        return 2 * (max((64 + 32) * row, out) + 4 * 32)
    if dp > 256:
        pitch = (WIDE_CHUNK + 16 // size) * size
        bn = 16 if dtype == _F32 else 32
        slots = 2 * 2 * 64 * bn * 4              # S and dP partials, twice
        return 2 * 64 * pitch + 2 * (2 * bn * pitch + 4 * nvec * bn) + slots
    pitch = (dp + 16 // size) * size
    if kernel == "K4a":
        bn = k4a_block_k(dtype, dk)
        resident = 64 * pitch if dp > 128 else 0
        return resident + 2 * (2 * bn * pitch + 4 * bn)
    if dtype == _F32:
        bn = 16 if dp > 192 else 32
    else:
        bn = 32 if dp > 96 else 64
    return 2 * 64 * pitch + 2 * (2 * bn * pitch + 4 * nvec * bn)



def k4_wide_split(dk: int) -> list:
    """The column chunks ``[(c0, width), ...]`` of the wide K4b's and K4c's
    cluster at head width ``dk`` (above 256), one a block in rank order
    (csrc/flash_attn_wide_bwd.cu's ``wide_split``): C = ceil(DP / 256)
    blocks over the padded width DP, each DP / C columns rounded up to 32
    and the last the rest, so that they cover [0, ``k4_padded_dim(dk)``)
    once: 2 x 192 at DP 384, 2 x 256 at 512, 224 + 224 + 192 at 640, 3 x
    256 at 768, 4 x 224 at 896, 4 x 256 at 1024."""
    dp = k4_padded_dim(dk)
    if dp <= 256:
        raise ValueError(f"head width {dk} runs no cluster (DP {dp})")
    blocks = -(-dp // WIDE_CHUNK)
    chunk = -(-(dp // blocks) // 32) * 32
    return [(c0, min(chunk, dp - c0)) for c0 in range(0, dp, chunk)]

def _scores(q, k, q_valid, kv_valid, sm_scale):
    """float32 scores with the additive segment mask, (B, H, Tq, Tk)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    allowed = q_valid[:, None, :, None] == kv_valid[:, None, None, :]
    return s + torch.where(allowed, 0.0, MASK_VALUE)


def flash_attention_reference(q, k, v, q_valid, kv_valid, *, sm_scale,
                              block_k=None):
    """Plain PyTorch version of K4a: (o in q's type, lse (B, H, Tq)
    float32).

    ``block_k=None`` takes the softmax at the row's final max.  With an
    int it walks the keys in tiles of ``block_k`` (the last one ragged) as
    the kernel does at ``block_k = k4a_block_k(dtype, D)``: a running max m
    and sum l per row, ``p = T(exp(s - m_new))`` at the tile's running
    max, the float32 accumulator rescaled by ``exp(m_old - m_new)`` before
    it gains ``p . v``, ``l`` summed from the unrounded p, and ``1 / l``
    at the end."""
    s = _scores(q, k, q_valid, kv_valid, sm_scale)
    if block_k is None:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                         v.float())
    else:
        m = torch.full_like(s[..., :1], -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape, dtype=_F32, device=q.device)
        for k0 in range(0, s.shape[-1], block_k):
            st = s[..., k0:k0 + block_k]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                v[:, :, k0:k0 + block_k].float())
            m = m_new
    inv = torch.where(l == 0, 1.0, 1.0 / l)
    return (o * inv).to(q.dtype), (m + torch.log(l))[..., 0]


def _grads_of_scores(q, k, v, q_valid, kv_valid, do, lse, di, sm_scale):
    """(p, ds), float32 (B, H, Tq, Tk), of the backward passes."""
    p = torch.exp(_scores(q, k, q_valid, kv_valid, sm_scale)
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, ((dp - di[..., None]) * p) * sm_scale


def flash_attention_dkv_reference(q, k, v, q_valid, kv_valid, do, lse, di,
                                  *, sm_scale):
    """Plain PyTorch version of K4b: (dk, dv) in k's and v's types."""
    p, ds = _grads_of_scores(q, k, v, q_valid, kv_valid, do, lse, di,
                             sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(do.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_reference(q, k, v, q_valid, kv_valid, do, lse, di,
                                 *, sm_scale):
    """Plain PyTorch version of K4c: dq in q's type."""
    _, ds = _grads_of_scores(q, k, v, q_valid, kv_valid, do, lse, di,
                             sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


_P, _I, _FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = (_I,) * 6 + (_FL, _P)       # B, H, Tq, Tk, D, is_bf16, scale, stream
_FWD_ARGS = (_P,) * 7 + _TAIL
_DKV_ARGS = (_P,) * 10 + _TAIL
_DQ_ARGS = (_P,) * 9 + _TAIL


def _check(what, q, k, v, q_valid, kv_valid, extra=(), rows=()):
    """Validate the kernels' operands: ``extra`` are (name, tensor) like
    q, ``rows`` (name, tensor) of (B, H, Tq); returns (B, H, Tq, Tk, D)."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if q.dtype not in (_F32, _BF16):
        raise NotImplementedError(f"{what} (kernel K4) takes float32 or "
                                  f"bfloat16, got {q.dtype}")
    if not flash_head_dim_supported(d):
        raise NotImplementedError(
            f"{what} (kernel K4) takes head widths that are multiples of "
            f"16 in [16, {MAX_HEAD_DIM}], got {d}")
    shapes = {"k": (k, (b, h, tk, d)), "v": (v, (b, h, tk, d))}
    shapes.update({name: (t, (b, h, tq, d)) for name, t in extra})
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {q.dtype}")
    for name, t, shape in (("q_valid", q_valid, (b, tq)),
                           ("kv_valid", kv_valid, (b, tk)),
                           *((n, t, (b, h, tq)) for n, t in rows)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, expected "
                             f"{shape}")
    tensors = [q, k, v, q_valid, kv_valid] + [t for _, t in extra + rows]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on {q.device}")
    if b * h > 65535:
        raise ValueError(f"{what}: B * H = {b * h} > 65535")
    return b, h, tq, tk, d


def _c(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return t.to(dtype).contiguous() if dtype is not None else t.contiguous()


def _tail(b, h, tq, tk, d, dtype, sm_scale, dev):
    return (b, h, tq, tk, d, int(dtype == _BF16), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream)


def flash_attention_forward(q, k, v, q_valid, kv_valid, *, sm_scale):
    """K4a: (o in q's type, lse (B, H, Tq) float32).  The kernel on CUDA
    tensors, ``flash_attention_reference`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_valid, kv_valid,
                                         sm_scale=sm_scale)
    b, h, tq, tk, d = _check("flash_attention_forward", q, k, v, q_valid,
                             kv_valid)
    dev = q.device
    with torch.cuda.device(dev):
        q, k, v = _c(q), _c(k), _c(v)
        qv, kv = _c(q_valid, torch.int32), _c(kv_valid, torch.int32)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, tq), dtype=_F32, device=dev)
        fn = kernel_call("flash_attn_fwd", _FWD_ARGS)
        check_launch("flash_attn_fwd", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(),
            kv.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_tail(b, h, tq, tk, d, q.dtype, sm_scale, dev)))
        flash_attention_forward.launches += 1
    return o, lse


flash_attention_forward.launches = 0


def flash_attention_dkv(q, k, v, q_valid, kv_valid, do, lse, di, *,
                        sm_scale):
    """K4b: (dk, dv).  The kernel on CUDA tensors,
    ``flash_attention_dkv_reference`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, q_valid, kv_valid, do,
                                             lse, di, sm_scale=sm_scale)
    b, h, tq, tk, d = _check("flash_attention_dkv", q, k, v, q_valid,
                             kv_valid, (("do", do),),
                             (("lse", lse), ("di", di)))
    dev = q.device
    with torch.cuda.device(dev):
        q, k, v, do = _c(q), _c(k), _c(v), _c(do)
        qv, kv = _c(q_valid, torch.int32), _c(kv_valid, torch.int32)
        lse, di = _c(lse, _F32), _c(di, _F32)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        fn = kernel_call("flash_attn_bwd_dkv", _DKV_ARGS)
        check_launch("flash_attn_bwd_dkv", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(),
            kv.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *_tail(b, h, tq, tk, d, q.dtype, sm_scale, dev)))
        flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_dq(q, k, v, q_valid, kv_valid, do, lse, di, *,
                       sm_scale):
    """K4c: dq.  The kernel on CUDA tensors,
    ``flash_attention_dq_reference`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, q_valid, kv_valid, do,
                                            lse, di, sm_scale=sm_scale)
    b, h, tq, tk, d = _check("flash_attention_dq", q, k, v, q_valid,
                             kv_valid, (("do", do),),
                             (("lse", lse), ("di", di)))
    dev = q.device
    with torch.cuda.device(dev):
        q, k, v, do = _c(q), _c(k), _c(v), _c(do)
        qv, kv = _c(q_valid, torch.int32), _c(kv_valid, torch.int32)
        lse, di = _c(lse, _F32), _c(di, _F32)
        dq = torch.empty_like(q)
        fn = kernel_call("flash_attn_bwd_dq", _DQ_ARGS)
        check_launch("flash_attn_bwd_dq", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qv.data_ptr(),
            kv.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), *_tail(b, h, tq, tk, d, q.dtype, sm_scale, dev)))
        flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0



def k4_wide_bwd_attrs(kernel: str, dtype: torch.dtype) -> tuple:
    """(registers a thread, local memory bytes) of the wide ``kernel``
    ('K4b' or 'K4c') instance in ``dtype``, as ``cudaFuncGetAttributes``
    gives them for the card's build: local memory is where ptxas spills,
    so a kernel that spills nothing has 0."""
    regs, local = ctypes.c_int(), ctypes.c_longlong()
    fn = kernel_call("flash_attn_wide_bwd_attrs",
                     (_I, _I, ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_longlong)))
    check_launch("flash_attn_wide_bwd_attrs", fn(
        {"K4b": 1, "K4c": 2}[kernel], int(dtype == _BF16),
        ctypes.byref(regs), ctypes.byref(local)))
    return regs.value, local.value

class _FlashAttention(torch.autograd.Function):
    """K4a forward; K4b and K4c backward.  The Function owns what the
    backward needs (q, k, v, the validities, o and lse): the kernels write
    their outputs through ctypes, outside autograd."""

    @staticmethod
    def forward(ctx, q, k, v, q_valid, kv_valid, sm_scale):
        o, lse = flash_attention_forward(q, k, v, q_valid, kv_valid,
                                         sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, q_valid, kv_valid, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_valid, kv_valid, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = (o.float() * do.float()).sum(-1)
        kw = dict(sm_scale=ctx.sm_scale)
        dk, dv = flash_attention_dkv(q, k, v, q_valid, kv_valid, do, lse,
                                     di, **kw)
        dq = flash_attention_dq(q, k, v, q_valid, kv_valid, do, lse, di,
                                **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, q_valid, kv_valid, *, sm_scale=None):
    """softmax(q k^T * sm_scale + segment mask) v over (B, H, T, D);
    ``sm_scale`` defaults to 1 / sqrt(D).  Differentiable in q, k and v
    (K4b/K4c); without autograd only K4a runs."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_valid, kv_valid,
                                     float(sm_scale))
    o, _ = flash_attention_forward(q, k, v, q_valid, kv_valid,
                                   sm_scale=sm_scale)
    return o
