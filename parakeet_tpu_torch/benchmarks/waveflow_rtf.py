"""WaveFlow synthesis speed of the port (counterpart of
``benchmarks/waveflow_rtf.py``): mel -> wave through the row sampler, at
batch 1.

The model has the widths of recipes/waveflow/conf/default.yaml (8 flows x
8 layers, n_group 16, 128 channels, upsampling 16 x 16;
``WAVEFLOW_CONFIG``, where the JAX bench builds the module's default 64
channels), flax's initializers drawn from a seed and each flow's output
projection drawn N(0, 0.01^2) (a fresh model's is zero, an identity flow
that trained weights are not).  The input is ``--frames`` (344, ~4 s at
22.05 kHz) standard normal mel frames and the noise of 88,064 samples is
drawn from a seed: the sampler's work does not depend on their values.
``--dtype`` is the sampler's activation type (``sample_act_dtype``): the
operands of its products in bf16, their sums float32, and the
parameters, conditioning, skips and affine inversion float32.

On the card the sampler (8 flows x 15 rows x 8 layers) is captured in one
CUDA graph whose inputs are the mel and the noise (``utils/graphs.py``);
each call multiplies the noise in place by ``1 + 0 * mean(wav)``, so that
chained replays depend on each other.  After 3 warm calls, ``--iters``
chained calls are timed from the host between two synchronisations,
graph and eager alike, and the graph's wav must equal the eager
program's bit for bit.

Prints one JSON line: ``metric`` ``waveflow_synthesis_rtf``, ``value``
(the graph's seconds a call over the audio's seconds), ``graph_ms``,
``eager_ms``, ``graph_matches_eager``, ``capture_s``, the analytic
``flops`` of a call (``utils/flops.py::waveflow_sampler_flops``),
``achieved_tflops`` and ``mfu_pct`` against the card's bf16 peak in both
dtypes (the JAX bench's convention), the dtype, backend, card and power
limit; ``vs_baseline`` is the reference implementation's V100 RTF, 0.025
(reference: docs/src/released_models.md:275), over this one.  On
``--device cpu`` the program runs eagerly only.

Usage:
  python -m parakeet_tpu_torch.benchmarks.waveflow_rtf \\
      [--frames 344] [--iters 10] [--dtype float32|bfloat16] [--device cpu]
"""
import argparse
import json

import numpy as np
import torch

from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from ..utils.flops import mfu_stats, waveflow_sampler_flops
from ..utils.graphs import CapturedProgram
from .common import (DTYPES, WAVEFLOW_CONFIG, card, seeded_waveflow,
                     timed_capture, wall_seconds)

__all__ = ["main", "run", "WaveFlowProgram"]

SAMPLE_RATE = 22050
FRAMES = 344
WARM_ITERS = 3
REFERENCE_RTF = 0.025
# the model's constructor arguments; tests shrink them
MODEL_CONFIG = WAVEFLOW_CONFIG


class WaveFlowProgram:
    """The sampler at batch 1 on seeded weights and inputs; ``inputs`` are
    the static buffers a captured graph reads."""

    def __init__(self, sample_dtype: torch.dtype, device: torch.device,
                 frames: int = FRAMES, seed: int = 0):
        model = seeded_waveflow(
            MODEL_CONFIG, torch.Generator().manual_seed(seed),
            None if sample_dtype == torch.float32 else sample_dtype)
        self.model = model.to(device).eval()
        n_mels = MODEL_CONFIG.get("n_mels", 80)
        mel = np.random.default_rng(seed).standard_normal(
            (1, frames, n_mels)).astype(np.float32)
        noise = torch.randn((1, model.samples(frames)),
                            generator=torch.Generator().manual_seed(seed + 1))
        self.inputs = {"mel": torch.from_numpy(mel).to(device),
                       "noise": noise.to(device)}

    @property
    def samples(self) -> int:
        return self.inputs["noise"].shape[1]

    def __call__(self, mel, noise):
        wav = self.model.infer(mel, noise=noise)
        noise.mul_(1.0 + 0.0 * wav.mean())
        return wav

    def eager(self):
        with torch.no_grad():
            return self(**self.inputs)

    def capture(self) -> CapturedProgram:
        """The whole sampler in one CUDA graph over ``inputs``."""
        return CapturedProgram(self, self.inputs)

    def flops(self) -> float:
        cfg = {k: MODEL_CONFIG[k] for k in (
            "n_flows", "n_layers", "n_group", "channels", "kernel_size")
            if k in MODEL_CONFIG}
        return waveflow_sampler_flops(
            self.samples, mel_bands=MODEL_CONFIG.get("n_mels", 80), **cfg)


def run(dtype: str, device: torch.device, iters: int, frames: int = FRAMES):
    """Build, time and check the sampler; returns (its record, the eager
    wav)."""
    program = WaveFlowProgram(DTYPES[dtype], device, frames)
    eager_s = wall_seconds(program.eager, device, iters, WARM_ITERS)
    want = program.eager()
    if not torch.isfinite(want).all():
        raise AssertionError(f"waveflow {dtype}: non-finite wav")
    name, limit = card(device)
    graph_s = same = capture_s = None
    if device.type == "cuda":
        graph, capture_s, _ = timed_capture(program, device)
        graph_s = wall_seconds(graph, device, iters, WARM_ITERS)
        same = bool(torch.equal(graph(), want))
    seconds = graph_s if graph_s is not None else eager_s
    audio_seconds = program.samples / SAMPLE_RATE
    rtf = seconds / audio_seconds
    flops = program.flops()
    return ({"metric": "waveflow_synthesis_rtf", "value": rtf, "unit": "rtf",
             "dtype": dtype, "vs_baseline": REFERENCE_RTF / rtf,
             "frames": frames, "samples": program.samples,
             "audio_seconds": audio_seconds,
             "graph_ms": None if graph_s is None else 1e3 * graph_s,
             "eager_ms": 1e3 * eager_s, "graph_matches_eager": same,
             "capture_s": capture_s, "flops": flops,
             **mfu_stats(flops, seconds, name), "backend": device.type,
             "tf32": tf32_enabled(),
             "device": name, "power_limit": limit}, want)


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--frames", type=int, default=FRAMES,
                        help="mel frames (~4 s at 22.05 kHz, hop 256)")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--dtype", default="float32", choices=DTYPES,
                        help="the sampler's activation dtype")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    record, _ = run(args.dtype, device, args.iters, args.frames)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
