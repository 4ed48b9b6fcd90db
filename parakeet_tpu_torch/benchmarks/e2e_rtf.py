"""End-to-end synthesis benchmark of the port (counterpart of the
repository's ``bench.py``): FastSpeech2 -> edge pad -> Parallel WaveGAN.

The program of ``bench.py`` at full width: FastSpeech2 (adim 384, 4 heads,
4 + 4 layers, eunits and dunits 1536) at 128 phone ids and a static
capacity of 896 frames, then the 30-layer PWGGenerator with upsampling
5 x 6 x 10: 268,800 samples, 11.2 s of 24 kHz audio, at batch 1.  Weights
are random, from a seed.  On the card the whole program is captured in
one CUDA graph; each call's noise is multiplied in place by
``1 + 0 * mean(wav)``, so chained replays depend on each other, as in
``bench.py``.  After 3 warm replays, 10 chained replays are timed from the
host between two synchronisations; the eager program is timed the same
way, and the graph's wav is compared with the eager one's.

Prints one JSON line with ``bench.py``'s keys (``metric``, ``value`` = the
graph's RTF, ``unit``, ``vs_baseline``, ``dtype``, ``achieved_tflops``,
``mfu_pct``) and ``peak_tflops``, ``backend``, ``device``, ``power_limit``,
``graph_ms``, ``eager_ms``, ``attn_impl``, ``launches`` (each kernel's
launches in one eager call, by its wrapper's counter), ``replay_kernels``
(the port's kernels in one replay, by name, from ``torch.profiler``),
``replay_kernels_total`` (every kernel and copy of that replay) and
``replay_busy_ms`` (the card's time in them: ``1 - replay_busy_ms /
graph_ms`` is its idle share).
``vs_baseline`` is null: ``bench.py``'s baseline, RTF 0.01, is a TPU
target, and the port has no baseline on the card yet.  MFU is taken
against the card's bf16 peak in both dtypes (``utils/flops.py``).  On
``--device cpu`` the program runs eagerly only: ``value`` is the CPU's
RTF and the card's metrics are null.

Usage:
  python -m parakeet_tpu_torch.benchmarks.e2e_rtf [--dtype bfloat16]
      [--attn-impl auto|dense|flash] [--iters 10] [--device cpu]
"""
import argparse
import json

import torch

from ..ops.kernels.flash_attn import flash_attention_forward
from ..ops.kernels.pwg_stack import fused_residual_stack
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from ..utils.flops import mfu_stats
from .common import (DTYPES, SynthesisProgram, build_models, card,
                     profiled_kernels, wall_seconds)

__all__ = ["main", "run"]

TEXT_LEN, MAX_FRAMES = 128, 896
WARM_ITERS = 3
# the kernels an inference program may launch, by PERF.md's ids
KERNELS = {"K1": fused_residual_stack, "K4a": flash_attention_forward}


def run(*, dtype: str, attn_impl: str, device: torch.device, iters: int,
        batch: int, text_len: int, max_frames: int,
        min_duration: int = 0) -> dict:
    """Build, time and check the program; returns the fields every
    synthesis benchmark prints (RTF and MFU at ``batch``, the graph's and
    eager times, the card)."""
    fs2, pwg = build_models(DTYPES[dtype], attn_impl, device)
    program = SynthesisProgram(fs2, pwg, batch=batch, text_len=text_len,
                               max_frames=max_frames,
                               min_duration=min_duration)
    flops = program.flops()
    eager_s = wall_seconds(program.eager, device, iters, WARM_ITERS)
    before = {k: f.launches for k, f in KERNELS.items()}
    want, frames = program.eager()
    launches = {k: f.launches - before[k] for k, f in KERNELS.items()}
    if not (torch.isfinite(want).all() and (frames > 0).all()):
        raise AssertionError(f"non-finite wav or empty frames {frames}")
    name, limit = card(device)
    graph_s = kernels = n_kernels = busy_ms = same = None
    if device.type == "cuda":
        graph = program.capture()
        graph_s = wall_seconds(graph, device, iters, WARM_ITERS)
        got, _ = graph()
        same = bool(torch.equal(got, want))
        kernels, n_kernels, busy_ms = profiled_kernels(graph)
    seconds = graph_s if graph_s is not None else eager_s
    return {"rtf": seconds * batch / program.audio_seconds,
            "audio_seconds": program.audio_seconds, "seconds": seconds,
            "dtype": dtype,
            **mfu_stats(flops, graph_s or 0.0, name), "flops": flops,
            "backend": device.type, "tf32": tf32_enabled(), "device": name,
            "power_limit": limit,
            "graph_ms": None if graph_s is None else 1e3 * graph_s,
            "eager_ms": 1e3 * eager_s, "graph_matches_eager": same,
            "attn_impl": attn_impl, "frame_lengths": frames.tolist(),
            "launches": launches, "replay_kernels": kernels,
            "replay_kernels_total": n_kernels, "replay_busy_ms": busy_ms}


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    parser.add_argument("--attn-impl", default="auto",
                        choices=("auto", "dense", "flash"),
                        help="FastSpeech2's attention core (at dk 96 and "
                             "896 frames 'auto' takes kernel K4a in the "
                             "decoder)")
    parser.add_argument("--iters", type=int, default=10)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    disable_tf32()
    res = run(dtype=args.dtype, attn_impl=args.attn_impl,
              device=set_device(args.device), iters=args.iters, batch=1,
              text_len=TEXT_LEN, max_frames=MAX_FRAMES)
    record = {"metric": "fastspeech2_pwgan_e2e_rtf", "value": res["rtf"],
              "unit": "rtf", "vs_baseline": None,
              **{k: v for k, v in res.items() if k != "rtf"}}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
