"""Autoregressive decode speed of the port (counterpart of
``benchmarks/ar_decode.py``): ms a decoder step of a batch-1 text -> mel
program over a fixed number of steps, the latency-critical inner loop of
interactive synthesis.

- ``tacotron2``: Tacotron2 at the JAX module's defaults (1024-wide
  LSTMs), ``infer`` over ``--steps`` decoder steps (its prenet's
  always-on dropout masks drawn once, from a fixed seed);
- ``transformer_tts``: TransformerTTS at the widths of
  recipes/transformer_tts/conf/default.yaml (adim 512 over 8 heads, 6 + 6
  layers; ``TRANSFORMER_TTS_CONFIG``, where the JAX bench builds the
  module's defaults) with ``--reduction-factor`` frames a step,
  ``inference`` over ``--steps`` steps.

Both read 96 phone ids (all valid) with flax's initializers drawn from a
seed; the whole program (encoder, loop, Postnet) is one CUDA graph on the
card, captured over its text and masks (``utils/graphs.py``), and must
give the eager program's mel bit for bit.  After ``--warmup`` (3) warm
calls, ``--iters`` calls are timed from the host between two
synchronisations.

Prints one JSON line a model: ``metric`` ``<model>_decode_ms_per_step``,
``value`` (the graph's ms a call over ``--steps``), ``reduction_factor``,
``am_only_rtf`` (the acoustic model's RTF at 22.05 kHz, hop 256),
``graph_ms``, ``eager_ms``, ``graph_matches_eager``, ``capture_s``,
``graph_pool_mib`` (the card memory the graph's pool keeps, the
allocator's cache emptied before and after the capture), the analytic
``step_flops`` (``utils/flops.py::ar_decode_step_flops``: twice the step
modules' weights, plus the attention context terms), ``achieved_tflops``
and ``mfu_pct`` (against the card's bf16 peak), the dtype, backend, card
and power limit.  On ``--device cpu`` the program runs eagerly only.

Usage:
  python -m parakeet_tpu_torch.benchmarks.ar_decode [--steps 500] \\
      [--iters 3] [--warmup 3] [--dtype float32|bfloat16] \\
      [--models tacotron2 transformer_tts] [--reduction-factor 1] \\
      [--device cpu]
"""
import argparse
import json

import numpy as np
import torch

from ..models import (Tacotron2, TransformerTTS, init_tacotron2_,
                      init_transformer_tts_)
from ..nn.precision import flax_dtype
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from ..utils.flops import ar_decode_step_flops, mfu_stats
from ..utils.graphs import CapturedProgram
from .common import (DTYPES, TRANSFORMER_TTS_CONFIG, card, timed_capture,
                     wall_seconds)

__all__ = ["main", "run", "DecodeProgram", "MODELS"]

MODELS = ("tacotron2", "transformer_tts")
TEXT_LEN, VOCAB, ODIM = 96, 80, 80
WARM_ITERS = 3
FRAME_RATE = 22050 / 256
# each model's constructor arguments; tests shrink them
MODEL_CONFIGS = {"tacotron2": {}, "transformer_tts": TRANSFORMER_TTS_CONFIG}


class DecodeProgram:
    """One model's text -> mel program at batch 1 over ``steps`` decoder
    steps on seeded weights and inputs; ``inputs`` are the static buffers
    a captured graph reads."""

    def __init__(self, name: str, dtype: torch.dtype, device: torch.device,
                 steps: int, reduction_factor: int = 1, seed: int = 0):
        if name not in MODELS:
            raise ValueError(f"unknown model {name!r}")
        self.name, self.steps = name, steps
        gen = torch.Generator().manual_seed(seed)
        if name == "tacotron2":
            am = Tacotron2(vocab_size=VOCAB, dtype=flax_dtype(dtype),
                           **MODEL_CONFIGS[name])
            init_tacotron2_(am, gen)
            self.r = 1
        else:
            am = TransformerTTS(idim=VOCAB, odim=ODIM,
                                reduction_factor=reduction_factor,
                                dtype=flax_dtype(dtype),
                                **MODEL_CONFIGS[name])
            init_transformer_tts_(am, gen)
            self.r = reduction_factor
        self.am = am.to(device).eval()
        text = np.random.default_rng(seed).integers(1, VOCAB, (1, TEXT_LEN))
        self.inputs = {"text": torch.as_tensor(text, device=device),
                       "text_lengths": torch.full((1,), TEXT_LEN,
                                                  device=device)}
        keep = self.am.prenet_masks(
            1, steps, torch.Generator().manual_seed(seed + 2), "cpu")
        if keep is not None:
            self.inputs["prenet_keep"] = keep.to(device)

    def __call__(self, text, text_lengths, prenet_keep=None):
        if self.name == "tacotron2":
            out = self.am.infer(text, text_lengths,
                                max_decoder_steps=self.steps,
                                prenet_keep=prenet_keep)
            return out["mel_outputs_postnet"], out["lengths"]
        out = self.am.inference(text, text_lengths,
                                max_decoder_steps=self.steps,
                                prenet_keep=prenet_keep)
        return out["mel"], out["lengths"]

    def eager(self):
        with torch.no_grad():
            return self(**self.inputs)

    def capture(self) -> CapturedProgram:
        return CapturedProgram(self, self.inputs)

    def step_flops(self) -> float:
        """FLOPs of one decoder step (the JAX bench's count)."""
        am = self.am
        if self.name == "tacotron2":
            return ar_decode_step_flops([am.cell, am.prenet],
                                        4.0 * TEXT_LEN * 128)
        attn = am.decoder.num_layers * 4.0 * am.adim * (self.steps
                                                        + TEXT_LEN)
        return ar_decode_step_flops(
            [am.decoder, am.decoder_prenet, am.decoder_prenet_proj,
             am.feat_out, am.prob_out], attn)


def run(name: str, *, dtype: str, device: torch.device, steps: int,
        iters: int, warmup: int = WARM_ITERS,
        reduction_factor: int = 1) -> dict:
    """Build, time and check one model's decode; returns its record."""
    program = DecodeProgram(name, DTYPES[dtype], device, steps,
                            reduction_factor)
    eager_s = wall_seconds(program.eager, device, iters, warmup)
    want, _ = program.eager()
    if not torch.isfinite(want).all():
        raise AssertionError(f"{name}: non-finite mel")
    dev_name, limit = card(device)
    graph_s = same = capture_s = pool_mib = None
    if device.type == "cuda":
        graph, capture_s, pool_mib = timed_capture(program, device)
        graph_s = wall_seconds(graph, device, iters, warmup)
        same = bool(torch.equal(graph()[0], want))
    seconds = graph_s if graph_s is not None else eager_s
    ms = 1e3 * seconds / steps
    step_flops = program.step_flops()
    return {"metric": f"{name}_decode_ms_per_step", "value": ms,
            "unit": "ms/step", "dtype": dtype,
            "reduction_factor": program.r, "steps": steps,
            "am_only_rtf": (ms / 1e3) * FRAME_RATE / program.r,
            "graph_ms": None if graph_s is None else 1e3 * graph_s,
            "eager_ms": 1e3 * eager_s, "graph_matches_eager": same,
            "capture_s": capture_s, "graph_pool_mib": pool_mib,
            "step_flops": step_flops,
            **mfu_stats(step_flops * steps, seconds, dev_name),
            "backend": device.type, "tf32": tf32_enabled(),
            "device": dev_name,
            "power_limit": limit}


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=WARM_ITERS)
    parser.add_argument("--dtype", default="float32", choices=DTYPES)
    parser.add_argument("--models", nargs="+", default=list(MODELS),
                        choices=MODELS)
    parser.add_argument("--reduction-factor", type=int, default=1,
                        help="transformer_tts frames a decoder step")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    records = []
    for name in args.models:
        records.append(run(name, dtype=args.dtype, device=device,
                           steps=args.steps, iters=args.iters,
                           warmup=args.warmup,
                           reduction_factor=args.reduction_factor))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
