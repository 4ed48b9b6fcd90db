"""FLOPs and MFU accounting of the port's benchmarks (counterpart of
``parakeet_tpu/utils/flops.py``: ``chip_peak_flops``, ``mfu_stats``,
``fs2_pwg_synthesis_flops`` and the analytic counts of the loops,
``waveflow_sampler_flops`` and ``ar_decode_step_flops``, and of the GE2E
train step, ``ge2e_train_flops``, which the JAX package reads from XLA's
cost model).

The JAX package takes its FLOP count from XLA's cost model; the port
counts the products and convolutions of one eager call with
``torch.utils.flop_counter.FlopCounterMode``.  Neither sees inside a
hand-written kernel (a Pallas custom call there, a ``ctypes`` launch here),
so both count an algorithmically identical program without one: the
residual stack's eager layer loop (``impl='eager'``, JAX's
``stack_impl='xla'``) and dense attention.

The peak is the card's, keyed on ``torch.cuda.get_device_name()``, never a
TPU's.  Kernel K1 forms its products in bf16 whatever the model's dtype,
so a float32 program's MFU is also taken against the bf16 peak: against
the float32 peak (67 TFLOP/s outside the tensor cores) the ~0.69 TFLOP of
the 30-layer stack at 268,800 samples in ~5 ms would read ~200%.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.parallel_wavegan import ResidualStack, edge_pad
from ..nn.transformer import MultiHeadAttention

__all__ = ["chip_peak_flops", "mfu_stats", "fs2_pwg_synthesis_flops",
           "waveflow_sampler_flops", "ar_decode_step_flops",
           "ge2e_train_flops"]

# NVIDIA's data sheet: dense bf16 tensor-core FLOP/s of the H100 SXM
# (700 W), by its full ``torch.cuda.get_device_name()``; the PCIe and NVL
# cards, named otherwise, have lower peaks and no entry
_PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def chip_peak_flops(device_name: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the card named ``device_name`` (as
    ``torch.cuda.get_device_name()`` gives it), or None for a device with
    no stated peak (the CPU, any other card)."""
    return _PEAK_BF16.get(device_name.strip())


def mfu_stats(flops_per_call: Optional[float], seconds_per_call: float,
              device_name: str) -> Dict[str, Optional[float]]:
    """{"achieved_tflops", "mfu_pct", "peak_tflops"}: the rate of one call,
    and its share of the card's bf16 peak (see the module's doc for why
    bf16 in both dtypes).  ``mfu_pct`` and ``peak_tflops`` are None where
    the device has no stated peak; every value is None without a count or
    a time."""
    peak = chip_peak_flops(device_name)
    if not flops_per_call or seconds_per_call <= 0:
        return {"achieved_tflops": None, "mfu_pct": None,
                "peak_tflops": None if peak is None else peak / 1e12}
    achieved = flops_per_call / seconds_per_call
    return {"achieved_tflops": achieved / 1e12,
            "mfu_pct": None if peak is None else 100.0 * achieved / peak,
            "peak_tflops": None if peak is None else peak / 1e12}


@contextlib.contextmanager
def _without_kernels(*modules):
    """Every residual stack on its eager loop and every attention on the
    dense core, inside the block."""
    saved = []
    for module in modules:
        for m in module.modules():
            if isinstance(m, ResidualStack):
                saved.append((m, "impl", m.impl))
                m.impl = "eager"
            elif isinstance(m, MultiHeadAttention):
                saved.append((m, "attn_core", m.attn_core))
                m.attn_core = None
    try:
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def fs2_pwg_synthesis_flops(fs2, pwg, text: torch.Tensor,
                            text_lengths: torch.Tensor, noise: torch.Tensor,
                            *, max_frames: int, min_duration: int = 0
                            ) -> float:
    """MFU denominator of the FastSpeech2 -> edge pad -> Parallel WaveGAN
    program (``benchmarks/e2e_rtf.py``, ``serving_throughput.py``,
    ``longform_rtf.py``): the FLOPs of one call, counted on the eager
    program without kernels (see the module's doc), on the models' own
    device.  Counts matrix products and convolutions only; XLA's count
    also takes elementwise work."""
    with torch.no_grad(), _without_kernels(fs2, pwg), \
            FlopCounterMode(display=False) as counter:
        out = fs2.inference(text, text_lengths, max_frames=max_frames,
                            min_duration=min_duration)
        pwg(noise, edge_pad(out["after_outs"], pwg.aux_context_window))
    return float(counter.get_total_flops())


def waveflow_sampler_flops(t_samples: int, *, n_flows: int = 8,
                           n_layers: int = 8, n_group: int = 16,
                           channels: int = 128, mel_bands: int = 80,
                           kernel_size=(3, 3)) -> float:
    """FLOPs of the WaveFlow sampler (``Flow.inverse``) at ``t_samples``:
    (n_group - 1) rows a flow, each pushing one (W, kh C) row through
    every layer's kw tap products, its conditioning and output
    projections, then the skips through the flow's output projection
    (the JAX package's count, copied)."""
    w = t_samples // n_group
    kh, kw = kernel_size
    c2 = 2 * channels
    per_layer = (kw * w * (kh * channels) * c2     # tap products
                 + w * mel_bands * c2              # conditioning 1x1
                 + w * channels * c2)              # out projection
    per_row = n_layers * per_layer + w * channels * 2   # + skips @ okern
    return 2.0 * per_row * (n_group - 1) * n_flows


def ar_decode_step_flops(modules, attn_context_flops: float = 0.0) -> float:
    """FLOPs of one step of a batch-1 autoregressive decode: each weight
    of the step's ``modules`` takes part in one product of a vector
    (2 FLOPs an element), plus the attention context terms, which grow
    with the attended length (``attn_context_flops``)."""
    n = sum(p.numel() for m in modules for p in m.parameters())
    return 2.0 * n + attn_context_flops


def ge2e_train_flops(utterances: int, frames: int, *, n_mels: int = 40,
                     num_layers: int = 3, hidden_size: int = 256,
                     output_size: int = 256, backward: bool = True
                     ) -> float:
    """FLOPs of a GE2E step over ``utterances`` x ``frames``: each LSTM
    layer's four gates take 2 x 4H x (in + H) a frame (the input and
    recurrent products), then the projection to the embedding; the
    backward's products (the inputs' and the weights' gradients) are
    twice the forward's.  ``FlopCounterMode`` does not see inside
    ``torch.lstm``; the similarity matrix and the softmax (N x M x N) are
    left out, as negligible."""
    h = hidden_size
    per_frame = sum(2 * 4 * h * ((n_mels if i == 0 else h) + h)
                    for i in range(num_layers))
    forward = utterances * (frames * per_frame + 2 * h * output_size)
    return float(3 * forward if backward else forward)
