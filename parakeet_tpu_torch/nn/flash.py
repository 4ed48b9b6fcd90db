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

from ..ops.kernels.flash_attn import (MAX_HEAD_DIM, flash_attention,
                                      flash_head_dim_supported)

__all__ = ["make_flash_attn_core", "make_auto_attn_core", "AUTO_FLASH_MIN_T",
           "auto_flash_head_dim", "flash_attention_available"]

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


def flash_attention_available() -> bool:
    """True where a CUDA device is present and K4's library builds (a
    failed build raises here; it is not reported as False).  On a machine
    without CUDA the flash core runs K4's plain versions on CPU tensors
    only, so this is False."""
    if not torch.cuda.is_available():
        return False
    from ..ops.kernels._build import load_library
    load_library()
    return True


def auto_flash_head_dim(dk: int) -> bool:
    """Head widths at which 'auto' takes K4: those it takes up to 128.

    At 192 (adim 384 over 2 heads, every FastSpeech2 recipe YAML) 'flash'
    runs K4 but 'auto' stays dense: measured on an NVIDIA H100 80GB HBM3
    at 700 W with ``fs2_sweep.py --aheads 2 --engine``, the float32 train
    step with flash over the dense one is 1.013 at 512 frames, 1.002 at
    1024, 1.028 at 2048, 1.069 at 4096 and 1.085 at 8192, so flash wins
    the train step at no length, though it wins no-grad inference
    (0.910-0.987) and the serving engine's 128-token chunk in bf16 as a
    graph (0.990 at batch 1, 0.962 at batch 4) (PERF.md, section 6).
    At 256 (adim 512 over 2 heads) likewise, on the same card and power
    limit (``NVIDIA H100 80GB HBM3, 700.00 W``) with ``fs2_sweep.py
    --adim 512 --aheads 2 --frames 512 1024 2048 4096``: the train step's
    ratio is 1.048 at 512 frames, 1.064 at 1024, 1.094 at 2048 and 1.180
    at 4096; no-grad inference 0.988, 0.960, 0.939 and 0.834.
    At 384 and 512 (adim 384 and 512 over one head, the wide instances,
    whose backward passes run as thread-block clusters) likewise, on the
    same card and power limit (``NVIDIA H100 80GB HBM3, 700.00 W``): with
    ``fs2_sweep.py --aheads 1 --frames 512 1024 2048 4096`` the float32
    train step's ratio at dk 384 is 1.092, 1.134, 1.229 and 1.361, no-grad
    inference 1.038, 1.087, 1.096 and 1.145; with ``--adim 512 --aheads
    1`` at dk 512 1.112, 1.144, 1.241 and 1.430, inference 1.053, 1.081,
    1.096 and 1.156.  Flash wins neither there."""
    return flash_head_dim_supported(dk) and dk <= 128


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
                f"multiples of 16 in [16, {MAX_HEAD_DIM}]; got dk={dk} "
                "(d_model / n_heads); use the dense core")
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
    lengths reach ``threshold`` and the head width is one where flash
    wins (``auto_flash_head_dim``), else None, which ``MultiHeadAttention``
    reads as "use the dense path" ('flash' raises at a width K4 does not
    take).  So 'auto' runs at every width, also at dk 192 from 1024
    frames, where the JAX 'auto' raises (jax's multi-step Pallas kernel
    takes no head width above 128 but multiples of 128).
    ``dense_fallback = True`` makes ``MultiHeadAttention`` fall back to
    dense, instead of raising, when training with attention-weight
    dropout.  The default threshold is the H100's (``AUTO_FLASH_MIN_T``)."""
    flash = make_flash_attn_core(seq_block=seq_block)

    def dispatch(q, k, v, mask=None):
        if (q.shape[1] < threshold or k.shape[1] < threshold
                or not auto_flash_head_dim(q.shape[-1])):
            return None
        return flash(q, k, v, mask)

    dispatch.dense_fallback = True
    return dispatch
