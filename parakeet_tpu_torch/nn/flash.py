"""Flash-attention core (counterpart of ``parakeet_tpu/nn/flash.py``).

Adapts kernel K4 (``ops/kernels/flash_attn.py``) to the ``attn_core``
interface of ``nn.transformer.MultiHeadAttention``:

    core(q, k, v, mask) -> out        # q, k, v, out: (B, T, H, dk)

The padding mask becomes per-row validities (jax's segment ids), exact for
any mask that factorizes into per-row validity (every mask the TTS models
feed).  Like the JAX core it has no attention-weight dropout
(``MultiHeadAttention`` raises if a nonzero rate would be lost) and returns
no attention weights.  On CPU tensors the core runs K4's plain versions;
on CUDA tensors it launches K4 or raises: no fallback.
"""
from __future__ import annotations

import math

import torch

from ..ops.kernels.flash_attn import flash_attention, flash_head_dim_supported

__all__ = ["make_flash_attn_core", "make_auto_attn_core", "AUTO_FLASH_MIN_T"]

# 'auto' takes flash attention once both lengths reach this, at the head
# widths K4 takes (dense at every other).  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W with fs2_sweep.py (float32 FastSpeech2 train steps at
# 16,384 frame tokens, adim 384 over 4 heads), two runs: the flash step
# over the dense one is 0.958 and 0.967 at 512 frames, 0.934-0.940 at
# 1024, 0.902-0.904 at 2048, 0.822-0.838 at 4096 and 0.752-0.760 at 8192;
# no-grad inference 0.60-0.94.  512 is the shortest length measured, so
# 'auto' switches there (PERF.md, section 6).  It holds in bf16 serving as
# well, on the same card with benchmarks/e2e_rtf.py (bench.py's program
# at 896 frames, one CUDA graph, in turns): flash 6.671 and 6.473 ms a
# call against dense 7.000 and 6.998; at 6,144 frames (longform_rtf.py)
# 35.8 against 49.1.  In float32 at 896 frames the two are within 0.7%.
AUTO_FLASH_MIN_T = 512


def _validity(mask, b, tq, tk, device=None):
    """Factorize a padding mask into per-row q/kv validity, int32 (B, T).

    ``mask``: bool, True = attendable, broadcastable to (B, 1, Tq, Tk)
    (ndim 3 means (B, 1, Tk)).  A position is q-valid if it may attend to
    anything, kv-valid if anything may attend to it.
    """
    if mask is None:
        return (torch.ones((b, tq), dtype=torch.int32, device=device),
                torch.ones((b, tk), dtype=torch.int32, device=device))
    if mask.ndim == 3:
        mask = mask[:, None]
    mask = torch.broadcast_to(mask, (b, 1, tq, tk))[:, 0]
    return (mask.any(dim=2).to(torch.int32),
            mask.any(dim=1).to(torch.int32))


def make_flash_attn_core(*, seq_block=None):
    """Build an ``attn_core`` running kernel K4.

    ``seq_block`` is accepted for signature parity with the JAX package,
    where it caps the Pallas kernel's TPU block size; K4 has fixed tiles
    and ignores it.
    """
    del seq_block

    def core(q, k, v, mask=None):
        b, tq, h, dk = q.shape
        tk = k.shape[1]
        if not flash_head_dim_supported(dk):
            raise NotImplementedError(
                f"flash attention (kernel K4) takes head widths that are "
                f"multiples of 16 in [16, 128]; got dk={dk} (d_model / "
                "n_heads); use the dense core")
        q_valid, kv_valid = _validity(mask, b, tq, tk, q.device)

        def heads(x):
            return x.transpose(1, 2).contiguous()       # (B, H, T, dk)

        out = flash_attention(heads(q), heads(k), heads(v), q_valid,
                              kv_valid, sm_scale=1.0 / math.sqrt(dk))
        return out.transpose(1, 2)                      # (B, Tq, H, dk)

    return core


def make_auto_attn_core(*, threshold: int = AUTO_FLASH_MIN_T,
                        seq_block=None):
    """Crossover-aware ``attn_core``: flash attention when both sequence
    lengths reach ``threshold`` and K4 takes the head width
    (``flash_head_dim_supported``), else None, which
    ``MultiHeadAttention`` reads as "use the dense path" (the JAX core takes
    every width, so 'auto' runs wherever the JAX 'auto' runs; 'flash'
    raises at a width K4 does not take).  ``dense_fallback = True`` makes
    ``MultiHeadAttention`` fall back to dense, instead of raising, when
    training with attention-weight dropout.  The default threshold is the
    H100's (``AUTO_FLASH_MIN_T``)."""
    flash = make_flash_attn_core(seq_block=seq_block)

    def dispatch(q, k, v, mask=None):
        if (q.shape[1] < threshold or k.shape[1] < threshold
                or not flash_head_dim_supported(q.shape[-1])):
            return None
        return flash(q, k, v, mask)

    dispatch.dense_fallback = True
    return dispatch
