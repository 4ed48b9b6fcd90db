"""Per-family end-to-end synthesis RTF of the port (counterpart of
``benchmarks/e2e_family_rtf.py``): acoustic model -> edge pad -> Parallel
WaveGAN, one program a family at batch 1.

The JAX bench's shapes: 96 phone ids (all valid) and a capacity of 1,000
mel frames, then the 30-layer PWGGenerator (residual 64, gate 128, skip
64) at the family's rate:

- ``tacotron2``: Tacotron2 at its default widths, ``infer`` over all
  1,000 decoder steps (its prenet's always-on dropout masks drawn once,
  from a fixed seed, as the JAX bench's fixed key), then PWG x256
  (upsampling 4 x 4 x 4 x 4): 256,000 samples at 22.05 kHz;
- ``transformer_tts_r1`` and ``transformer_tts_r2``: TransformerTTS at
  the widths of recipes/transformer_tts/conf/default.yaml (adim 512 over 8
  heads, 6 + 6 layers; ``TRANSFORMER_TTS_CONFIG``, where the JAX bench
  builds the module's defaults) with reduction factor 1 or 2,
  ``inference`` over all 1,000 // r decoder steps (its decoder prenet's
  masks drawn once, from a fixed seed), then PWG x256: 256,000 samples;
- ``speedyspeech``: SpeedySpeech at its default widths (8 tones),
  ``inference(max_frames=1000)``, then PWG x300 (5 x 6 x 10, the JAX
  bench's scales): 300,000 samples at 24 kHz.

Weights are random, from a seed: the acoustic models take flax's
initializers (``init_tacotron2_``, ``init_transformer_tts_``,
``init_flax_defaults_``), the vocoder ``seeded_init_``; the work of a
call does not depend on where the random heads stop or how long they
make a phone.  On the card each
program is captured in one CUDA graph (``utils/graphs.py``); each call's
noise is multiplied in place by ``1 + 0 * mean(wav)``, so chained
replays depend on each other.  After 3 warm calls, ``--iters`` chained
calls are timed from the host between two synchronisations, graph and
eager alike, and the graph's wav must equal the eager program's bit for
bit.

Prints one JSON line a family: ``metric`` ``<family>_pwgan_e2e_rtf``,
``value`` (the graph's RTF: seconds a call over the audio's capacity),
``audio_seconds``, ``graph_ms``, ``eager_ms``, ``graph_matches_eager``,
``launches`` (K1's launches in one eager call, by its wrapper's counter),
``replay_kernels`` (the port's kernels in one replay, by name, from
``torch.profiler``), ``replay_kernels_total``, ``replay_busy_ms``,
``frame_lengths``, ``capture_s`` (the capture, its two warm-up runs
included) and ``graph_pool_mib`` (the card memory the graph's pool
keeps: reserved after the capture less before it, the allocator's cache
emptied on both sides),
the dtype, backend, card and power limit.
``vs_baseline`` is null (the JAX bench's 0.01 is a TPU target).  On
``--device cpu`` the program runs eagerly only.

Usage:
  python -m parakeet_tpu_torch.benchmarks.e2e_family_rtf \\
      [--families tacotron2 speedyspeech] [--iters 10] [--frames 1000] \\
      [--dtype bfloat16|float32] [--device cpu]

Every leg of the JAX bench runs: ``tacotron2``, ``transformer_tts_r1``,
``transformer_tts_r2`` and ``speedyspeech``; an unknown family raises.
"""
import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..models import (PWGGenerator, SpeedySpeech, Tacotron2, TransformerTTS,
                      init_tacotron2_, init_transformer_tts_)
from ..models.parallel_wavegan import edge_pad
from ..nn.initializer import init_flax_defaults_
from ..nn.precision import flax_dtype
from ..ops.kernels.pwg_stack import fused_residual_stack
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from ..utils.graphs import CapturedProgram
from .common import (DTYPES, TRANSFORMER_TTS_CONFIG, card, profiled_kernels,
                     seeded_init_, timed_capture, wall_seconds)

__all__ = ["main", "run", "FamilyProgram", "FAMILIES"]

FAMILIES = ("tacotron2", "transformer_tts_r1", "transformer_tts_r2",
            "speedyspeech")
TEXT_LEN, FRAMES = 96, 1000
VOCAB, TONES, ODIM = 80, 8, 80
WARM_ITERS = 3
# (sample rate, PWG upsample scales) of each family's vocoder
VOCODER = {"tacotron2": (22050, (4, 4, 4, 4)),
           "transformer_tts_r1": (22050, (4, 4, 4, 4)),
           "transformer_tts_r2": (22050, (4, 4, 4, 4)),
           "speedyspeech": (24000, (5, 6, 10))}
PWG_CONFIG = dict(layers=30, stacks=3, residual_channels=64,
                  gate_channels=128, skip_channels=64, aux_context_window=2)
# each family's constructor arguments beyond the JAX bench's (Tacotron2
# and SpeedySpeech: none, their defaults; TransformerTTS: its recipe's
# widths); tests shrink them
MODEL_CONFIGS = {"tacotron2": {}, "speedyspeech": {},
                 "transformer_tts": TRANSFORMER_TTS_CONFIG}


class FamilyProgram:
    """One family's text -> wav program at batch 1 on seeded inputs and
    weights; ``inputs`` are the static buffers a captured graph reads."""

    def __init__(self, family: str, dtype: torch.dtype,
                 device: torch.device, seed: int = 0,
                 frames: Optional[int] = None):
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}")
        self.family = family
        self.sample_rate, scales = VOCODER[family]
        gen = torch.Generator().manual_seed(seed)
        # decoder steps a call: 1,000 frames (``frames``), r a step
        self.frames = frames = frames or FRAMES
        self.steps = frames
        mixed = flax_dtype(dtype)
        if family == "tacotron2":
            am = Tacotron2(vocab_size=VOCAB, dtype=mixed,
                           **MODEL_CONFIGS[family])
            init_tacotron2_(am, gen)
        elif family.startswith("transformer_tts"):
            r = int(family.rsplit("r", 1)[1])
            am = TransformerTTS(idim=VOCAB, odim=ODIM, reduction_factor=r,
                                dtype=mixed,
                                **MODEL_CONFIGS["transformer_tts"])
            init_transformer_tts_(am, gen)
            self.steps = frames // r
        else:
            am = SpeedySpeech(vocab_size=VOCAB, tone_size=TONES, dtype=mixed,
                              **MODEL_CONFIGS[family])
            init_flax_defaults_(am, gen)
        pwg = PWGGenerator(**PWG_CONFIG, upsample_scales=scales, dtype=mixed)
        seeded_init_(pwg, gen)
        self.am = am.to(device).eval()
        self.pwg = pwg.to(device).eval()
        rng = np.random.default_rng(seed)
        noise_gen = torch.Generator().manual_seed(seed + 4)
        self.inputs: Dict[str, torch.Tensor] = {
            "text": torch.as_tensor(rng.integers(1, VOCAB, (1, TEXT_LEN)),
                                    device=device),
            "noise": torch.randn((1, frames * self.pwg.upsample_factor, 1),
                                 generator=noise_gen).to(device)}
        if family != "speedyspeech":
            self.inputs["text_lengths"] = torch.full((1,), TEXT_LEN,
                                                     device=device)
            keep = self.am.prenet_masks(
                1, self.steps, torch.Generator().manual_seed(seed + 2),
                "cpu")
            if keep is not None:
                self.inputs["prenet_keep"] = keep.to(device)
        else:
            self.inputs["tones"] = torch.as_tensor(
                rng.integers(0, TONES, (1, TEXT_LEN)), device=device)

    @property
    def audio_seconds(self) -> float:
        """Seconds of audio a call returns (its capacity)."""
        return self.inputs["noise"].shape[1] / self.sample_rate

    def __call__(self, text, noise, tones=None, text_lengths=None,
                 prenet_keep=None):
        """(wav (1, samples), frame lengths (1,)) of one call."""
        if self.family == "tacotron2":
            out = self.am.infer(text, text_lengths,
                                max_decoder_steps=self.frames,
                                prenet_keep=prenet_keep)
            mel, lengths = out["mel_outputs_postnet"], out["lengths"]
        elif self.family != "speedyspeech":
            out = self.am.inference(text, text_lengths,
                                    max_decoder_steps=self.steps,
                                    prenet_keep=prenet_keep)
            mel, lengths = out["mel"], out["lengths"]
        else:
            out = self.am.inference(text, tones, max_frames=self.frames)
            mel, lengths = out["mel"], out["frame_lengths"]
        wav = self.pwg(noise, edge_pad(mel, self.pwg.aux_context_window))
        wav = wav[..., 0]
        noise.mul_(1.0 + 0.0 * wav.float().mean())
        return wav, lengths

    def eager(self):
        with torch.no_grad():
            return self(**self.inputs)

    def capture(self) -> CapturedProgram:
        """The whole program in one CUDA graph over ``inputs``."""
        return CapturedProgram(self, self.inputs)


def run(family: str, *, dtype: str, device: torch.device, iters: int,
        warmup: int = WARM_ITERS, frames: Optional[int] = None) -> dict:
    """Build, time and check one family's program (``frames`` of
    capacity, ``FRAMES`` by default); returns its record."""
    program = FamilyProgram(family, DTYPES[dtype], device, frames=frames)
    eager_s = wall_seconds(program.eager, device, iters, warmup)
    before = fused_residual_stack.launches
    want, lengths = program.eager()
    launches = {"K1": fused_residual_stack.launches - before}
    if not torch.isfinite(want).all():
        raise AssertionError(f"{family}: non-finite wav")
    name, limit = card(device)
    graph_s = kernels = n_kernels = busy_ms = same = None
    capture_s = pool_mib = None
    if device.type == "cuda":
        graph, capture_s, pool_mib = timed_capture(program, device)
        graph_s = wall_seconds(graph, device, iters, warmup)
        got, _ = graph()
        same = bool(torch.equal(got, want))
        kernels, n_kernels, busy_ms = profiled_kernels(graph)
    seconds = graph_s if graph_s is not None else eager_s
    return {"metric": f"{family}_pwgan_e2e_rtf",
            "value": seconds / program.audio_seconds, "unit": "rtf",
            "audio_seconds": program.audio_seconds, "vs_baseline": None,
            "dtype": dtype, "backend": device.type, "tf32": tf32_enabled(),
            "device": name,
            "power_limit": limit,
            "graph_ms": None if graph_s is None else 1e3 * graph_s,
            "eager_ms": 1e3 * eager_s, "graph_matches_eager": same,
            "launches": launches, "replay_kernels": kernels,
            "replay_kernels_total": n_kernels, "replay_busy_ms": busy_ms,
            "frame_lengths": lengths.tolist(),
            "samples": int(want.shape[-1]), "capture_s": capture_s,
            "graph_pool_mib": pool_mib}


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--families", nargs="+", default=list(FAMILIES))
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=WARM_ITERS)
    parser.add_argument("--frames", type=int, default=None,
                        help=f"mel frames of capacity (default {FRAMES})")
    parser.add_argument("--dtype", default="bfloat16", choices=DTYPES,
                        help="the programs' compute dtype (flax's dtype=: "
                             "float32 parameters)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    for family in args.families:
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}")
    device = set_device(args.device)
    disable_tf32()
    records = []
    for family in args.families:
        records.append(run(family, dtype=args.dtype, device=device,
                           iters=args.iters, warmup=args.warmup,
                           frames=args.frames))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
