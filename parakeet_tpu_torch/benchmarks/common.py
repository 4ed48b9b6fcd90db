"""What the port's synthesis benchmarks share (``e2e_rtf``,
``serving_throughput``, ``serving_engine``, ``serving_latency``,
``longform_rtf``): the models of ``bench.py`` with seeded weights, the
program FastSpeech2 -> edge pad -> Parallel WaveGAN at a static shape, its
timing eagerly and as one CUDA graph, and the card's name and power
limit; and the TransformerTTS and WaveFlow widths of their recipes'
YAMLs, which the per-family benches build, and WaveFlow's seeded
weights."""
from __future__ import annotations

import collections
import math
import re
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import (ConditionalWaveFlow, FastSpeech2, PWGGenerator,
                      init_waveflow_)
from ..models.parallel_wavegan import edge_pad
from ..nn.precision import flax_dtype
from ..utils.flops import fs2_pwg_synthesis_flops
from ..utils.graphs import CapturedProgram

__all__ = ["FS2_CONFIG", "PWG_CONFIG", "SAMPLE_RATE", "seeded_init_",
           "build_models", "card", "SynthesisProgram", "wall_seconds",
           "profiled_kernels", "PROFILE_TRIES", "DTYPES", "timed_capture",
           "TRANSFORMER_TTS_CONFIG", "WAVEFLOW_CONFIG", "seeded_waveflow"]

SAMPLE_RATE = 24000
# bench.py's models: FastSpeech2 (idim = odim = 80) and the 300x PWGGenerator
FS2_CONFIG = dict(idim=80, odim=80, adim=384, aheads=4, elayers=4,
                  eunits=1536, dlayers=4, dunits=1536)
PWG_CONFIG = dict(layers=30, stacks=3, residual_channels=64,
                  gate_channels=128, skip_channels=64,
                  upsample_scales=(5, 6, 10), aux_context_window=2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the model sections of recipes/transformer_tts/conf/default.yaml (without
# init_type and the reduction factor, which each leg sets) and of
# recipes/waveflow/conf/default.yaml: the widths users train.  The JAX
# benches build the modules' defaults instead (TransformerTTS: 4 heads and
# a 3-convolution encoder prenet; WaveFlow: 64 channels)
TRANSFORMER_TTS_CONFIG = dict(
    embed_dim=0, eprenet_conv_layers=0, eprenet_conv_chans=0,
    eprenet_conv_filts=0, dprenet_layers=2, dprenet_units=256, adim=512,
    aheads=8, elayers=6, eunits=1024, dlayers=6, dunits=1024,
    positionwise_layer_type="conv1d", positionwise_conv_kernel_size=1,
    postnet_layers=5, postnet_filts=5, postnet_chans=256,
    use_scaled_pos_enc=True)
WAVEFLOW_CONFIG = dict(upsample_factors=(16, 16), n_flows=8, n_layers=8,
                       n_group=16, channels=128, n_mels=80,
                       kernel_size=(3, 3), sigma=1.0)
# the spread of WaveFlow's output projections in the benches
WAVEFLOW_OUTPUT_STD = 0.01
# the random AM's log-durations are centred on log(5) with a spread of
# about 0.25: ~4 frames (~50 ms at hop 300 / 24 kHz) a phone
DURATION_BIAS, DURATION_SPREAD = math.log(5.0), 0.25


def seeded_init_(module, gen: torch.Generator) -> None:
    """Stand-in for trained weights, drawn from ``gen``: biases N(0, 0.02),
    scales (LayerNorm, BatchNorm, weight norm) and alphas 1, every other
    tensor N(0, 1 / fan_in) with fan_in the size of one output row."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            elif leaf.endswith("scale") or leaf == "alpha" or p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(p[0].numel()))


def seeded_waveflow(config: dict, gen: torch.Generator,
                    sample_act_dtype: Optional[torch.dtype] = None
                    ) -> ConditionalWaveFlow:
    """WaveFlow of ``config`` with flax's initializers drawn from ``gen``
    (``init_waveflow_``), then every flow's output projection kernel
    N(0, ``WAVEFLOW_OUTPUT_STD``^2) from ``gen``: at its initial zero each
    flow is the identity, which would time and check nothing."""
    model = ConditionalWaveFlow(**config, sample_act_dtype=sample_act_dtype)
    init_waveflow_(model, gen)
    with torch.no_grad():
        for flow in model.decoder.flows():
            flow.output_proj.weight.normal_(0.0, WAVEFLOW_OUTPUT_STD,
                                            generator=gen)
    return model


def build_models(dtype: torch.dtype, attn_impl: str, device: torch.device,
                 seed: int = 0) -> Tuple[FastSpeech2, PWGGenerator]:
    """``FS2_CONFIG`` and ``PWG_CONFIG`` computing in ``dtype`` (flax's
    ``dtype=``: float32 parameters) on ``device``, in eval mode, with
    weights from ``seeded_init_`` and a duration head of ~4 frames a
    phone."""
    gen = torch.Generator().manual_seed(seed)
    fs2 = FastSpeech2(**FS2_CONFIG, attn_impl=attn_impl,
                      dtype=flax_dtype(dtype))
    pwg = PWGGenerator(**PWG_CONFIG, dtype=flax_dtype(dtype))
    seeded_init_(fs2, gen)
    seeded_init_(pwg, gen)
    with torch.no_grad():
        fs2.duration_predictor.stack.linear.weight.mul_(DURATION_SPREAD)
        fs2.duration_predictor.stack.linear.bias.fill_(DURATION_BIAS)
    return fs2.to(device).eval(), pwg.to(device).eval()


def card(device: torch.device) -> Tuple[str, Optional[str]]:
    """(device name, power limit) as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them for a CUDA device; ("cpu", None) else."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else 0
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    name, limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_seconds(fn, device: torch.device, iters: int, warmup: int) -> float:
    """Wall seconds a call of ``fn()``: ``warmup`` calls, then ``iters``
    chained calls between two synchronisations."""
    for _ in range(warmup):
        fn()
    sync(device)
    tic = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - tic) / iters


def timed_capture(program, device: torch.device):
    """(``program.capture()``, its wall seconds with its warm-up runs, the
    MiB of card memory its graph's pool keeps): reserved memory after the
    capture less before it, the allocator's cache emptied on both sides
    so that only the pool and the output buffers stay reserved."""
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    tic = time.perf_counter()
    graph = program.capture()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - tic
    torch.cuda.empty_cache()
    return graph, seconds, (torch.cuda.memory_reserved(device)
                            - reserved) / 2 ** 20


class SynthesisProgram:
    """``bench.py``'s program at batch ``batch``: ``text_len`` phone ids
    (all valid) -> ``fs2.inference(max_frames)`` -> edge pad -> ``pwg``,
    on seeded inputs.  Each call multiplies the noise in place by
    ``1 + 0 * mean(wav)``, so that chained calls depend on each other
    (``bench.py:64-66``)."""

    def __init__(self, fs2, pwg, *, batch: int, text_len: int,
                 max_frames: int, min_duration: int = 0, seed: int = 0):
        self.fs2, self.pwg = fs2, pwg
        self.max_frames, self.min_duration = max_frames, min_duration
        self.device = next(pwg.parameters()).device
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed + 2)
        self.inputs = {
            "text": torch.as_tensor(rng.integers(1, FS2_CONFIG["idim"],
                                                 (batch, text_len)),
                                    device=self.device),
            "text_lengths": torch.full((batch,), text_len,
                                       device=self.device),
            "noise": torch.randn((batch, max_frames * pwg.upsample_factor,
                                  1), generator=gen).to(self.device)}

    @property
    def audio_seconds(self) -> float:
        """Seconds of audio a call returns (its capacity, as bench.py)."""
        b, n, _ = self.inputs["noise"].shape
        return b * n / SAMPLE_RATE

    def __call__(self, text, text_lengths, noise):
        out = self.fs2.inference(text, text_lengths,
                                 max_frames=self.max_frames,
                                 min_duration=self.min_duration)
        mel = edge_pad(out["after_outs"], self.pwg.aux_context_window)
        wav = self.pwg(noise, mel)[..., 0]
        noise.mul_(1.0 + 0.0 * wav.float().mean())
        return wav, out["frame_lengths"]

    def eager(self):
        with torch.no_grad():
            return self(**self.inputs)

    def capture(self) -> CapturedProgram:
        """The whole program in one CUDA graph over ``inputs``."""
        return CapturedProgram(self, self.inputs)

    def flops(self) -> float:
        """FLOPs of one call (``utils/flops.py``), on a copy of the noise."""
        inp = self.inputs
        return fs2_pwg_synthesis_flops(
            self.fs2, self.pwg, inp["text"], inp["text_lengths"],
            inp["noise"].clone(), max_frames=self.max_frames,
            min_duration=self.min_duration)


# the port's kernels (csrc/) that an inference program launches, as the
# profiler's demangled names begin; a name is cut to "kernel<arguments>"
PORT_KERNELS = ("pwg_layer_kernel", "flash_fwd_kernel")
# how many times profiled_kernels runs and profiles its function
PROFILE_TRIES = 3
_SHORT_NAME = re.compile(r"(\w+<[^()]*>)\(")


def profiled_kernels(fn) -> Tuple[Dict[str, int], int, float]:
    """``fn()`` (a graph's replay, a batch through the engine) under
    ``torch.profiler``: the port's kernels it ran on the card, by name (as
    ``pwg_layer_kernel<64, false>``), its count of CUDA kernels and copies
    in all, and the ms the card was busy with them (the sum of their
    spans) -- the proof that a graph holds the hand-written kernels, what
    a replay launches (the wrappers' counters advance only at capture),
    and its device time.  ``fn`` runs PROFILE_TRIES times, each under a
    profile of its own, and the profile that recorded the most CUDA
    events counts: the tracer now and then drops records of a replay (69
    of 658 kernels once, 290 of 525 another time), and never adds any."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    events = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(got) > len(events):
            events = got
    port = collections.Counter(
        m.group(1) if (m := _SHORT_NAME.search(e.name)) else e.name
        for e in events if any(k in e.name for k in PORT_KERNELS))
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return dict(port), len(events), busy_ms
