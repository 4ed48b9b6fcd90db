"""``TTSEngine`` throughput of the port on a mixed-length workload
(counterpart of ``benchmarks/serving_engine.py``).

``serving_throughput`` measures the fixed-shape capacity ceiling; real
traffic is mixed-length.  This runs the port's engine (``serving.py``) on
``bench.py``'s models over a skewed length distribution and reports
end-to-end audio-s/s including the host's scheduling, padding waste and
per-chunk copies, for the bucket grid against one pad-to-max bucket (what
bucketing buys) and, for the grid, one CUDA graph per grid point against
the eager engine (what the graphs buy), with the memory the graphs hold.

Usage:
  python -m parakeet_tpu_torch.benchmarks.serving_engine [--requests 64]
      [--dtype bfloat16] [--buckets 32 64 128] [--batch-size 8]
      [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from ..serving import Request, TTSEngine
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from .common import DTYPES, SAMPLE_RATE, build_models, card

__all__ = ["main", "build_engine", "workload", "run"]


def build_engine(models, text_buckets, batch_size, frames_per_token,
                 graphs):
    """An engine on ``models`` (FastSpeech2, PWGGenerator) over
    ``text_buckets`` and the batch buckets 1, 2, 4 and ``batch_size``."""
    fs2, pwg = models
    return TTSEngine(fs2, voc=pwg, text_buckets=tuple(text_buckets),
                     batch_buckets=tuple(sorted({1, 2, 4, batch_size})),
                     frames_per_token=frames_per_token, min_duration=1,
                     graphs=graphs)


def workload(n, lo, hi, seed=0):
    """Skewed mixed-length traffic: mostly short, a long tail."""
    rng = np.random.default_rng(seed)
    lengths = np.clip((lo + rng.exponential((hi - lo) / 3, n)).astype(int),
                      lo, hi)
    return [Request(ids=rng.integers(1, 80, k).tolist(), utt_id=f"u{i}",
                    seed=i) for i, k in enumerate(lengths)]


def run(engine, reqs, repeats):
    """(audio seconds, wall seconds a pass, results): a first pass that
    builds and warms the grid points the workload hits, a throwaway warm
    pass, then ``repeats`` timed passes."""
    results = engine.synthesize(reqs)
    engine.synthesize(reqs)
    tic = time.perf_counter()
    for _ in range(repeats):
        results = engine.synthesize(reqs)
    elapsed = (time.perf_counter() - tic) / repeats
    audio = sum(r.wav.shape[0] for r in results) / SAMPLE_RATE
    return audio, elapsed, results


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--requests", type=int, default=64)
    parser.add_argument("--min-len", type=int, default=20)
    parser.add_argument("--buckets", type=int, nargs="+",
                        default=(32, 64, 128))
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--frames-per-token", type=int, default=7)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    on_card = device.type == "cuda"
    max_len = max(args.buckets)
    models = build_models(DTYPES[args.dtype], "auto", device)
    reqs = workload(args.requests, args.min_len, max_len)

    def measure(buckets, graphs):
        engine = build_engine(models, buckets, args.batch_size,
                              args.frames_per_token, graphs)
        if on_card:
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(device)
        audio, elapsed, results = run(engine, reqs, args.repeats)
        held = None
        if on_card and graphs:      # what stays reserved: the graphs' pool
            torch.cuda.empty_cache()
            held = (torch.cuda.memory_reserved(device) - before) / 2 ** 30
        return audio / elapsed, audio, elapsed, engine, held, results

    value, audio, elapsed, engine, held, results = measure(args.buckets,
                                                           on_card)
    flat, *_ = measure((max_len,), on_card)
    eager = graphs_speedup = same = None
    if on_card:
        eager, *_, eager_results = measure(args.buckets, False)
        graphs_speedup = value / eager
        same = all(np.array_equal(a.wav, b.wav)
                   for a, b in zip(results, eager_results))
    name, limit = card(device)
    record = {"metric": "tts_engine_mixed_workload_throughput",
              "value": value, "unit": "audio_seconds/sec",
              "requests": args.requests, "audio_seconds": audio,
              "wall_sec": elapsed, "programs": engine.compiled_programs,
              "pad_to_max_value": flat, "bucketing_speedup": value / flat,
              "graphs": on_card, "eager_value": eager,
              "graphs_speedup": graphs_speedup,
              "graphs_match_eager": same,
              "graph_reserved_gib": held, "dtype": args.dtype,
              "attn_impl": "auto", "backend": device.type,
              "tf32": tf32_enabled(),
              "device": name, "power_limit": limit}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
