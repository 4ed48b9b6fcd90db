"""Serving latency of the port under load: p50/p99 against arrival rate
(counterpart of ``benchmarks/serving_latency.py``).

``serving_engine`` measures capacity (audio-s/s); a deployment also plans
against latency at a traffic level.  This simulates one server in front
of the port's engine (``serving_engine``'s models, grid and mixed-length
workload):

- requests arrive by a Poisson process at ``--rates`` requests/s, on a
  virtual clock;
- whenever the server is free it waits ``--window`` ms after the next
  arrival, then takes everything that has arrived, up to the largest
  batch bucket, into one ``engine.synthesize``;
- that call's real wall time advances the virtual clock; a request's
  latency is its batch's completion time minus its arrival.

The grid is captured and warmed first (``engine.warmup``), so the numbers
are steady-state serving.  One JSON line a rate: p50/p95/p99 latency,
mean batch size and the server's utilization.

Usage:
  python -m parakeet_tpu_torch.benchmarks.serving_latency
      [--rates 1 2 4 8] [--requests 64] [--window 0] [--dtype bfloat16]
      [--device cpu]
"""
import argparse
import json
import time

import numpy as np

from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from .common import DTYPES, build_models, card
from .serving_engine import build_engine, workload

__all__ = ["main", "simulate"]


def simulate(engine, reqs, rate, window_s, cap, seed=0,
             clock=time.perf_counter):
    """(latencies in s, batch sizes, utilization) of ``reqs`` arriving at
    ``rate`` a second; ``clock`` times each batch's service."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, len(reqs)))
    latencies = np.zeros(len(reqs))
    batch_sizes = []
    busy = now = 0.0
    i = 0
    while i < len(reqs):
        # server idle: jump to the next arrival, then apply the window
        now = max(now, arrivals[i]) + window_s
        take = i
        while take < len(reqs) and arrivals[take] <= now and take - i < cap:
            take += 1
        tic = clock()
        engine.synthesize(reqs[i:take])
        service = clock() - tic
        done = now + service
        latencies[i:take] = done - arrivals[i:take]
        batch_sizes.append(take - i)
        busy += service
        now = done
        i = take
    return latencies, batch_sizes, busy / max(now, 1e-9)


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rates", type=float, nargs="+",
                        default=(1.0, 2.0, 4.0, 8.0),
                        help="arrival rates, requests/sec")
    parser.add_argument("--requests", type=int, default=64)
    parser.add_argument("--min-len", type=int, default=20)
    parser.add_argument("--buckets", type=int, nargs="+",
                        default=(32, 64, 128))
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--frames-per-token", type=int, default=7)
    parser.add_argument("--window", type=float, default=0.0,
                        help="batching window, ms (wait after the first "
                             "queued request before launching)")
    parser.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    engine = build_engine(build_models(DTYPES[args.dtype], "auto",
                                       device),
                          args.buckets, args.batch_size,
                          args.frames_per_token, device.type == "cuda")
    engine.warmup()
    reqs = workload(args.requests, args.min_len, max(args.buckets))
    name, limit = card(device)
    records = []
    for rate in args.rates:
        lats, sizes, util = simulate(engine, reqs, rate, args.window / 1e3,
                                     engine.batch_buckets[-1])
        record = {"metric": "serving_latency", "rate_rps": rate,
                  "requests": len(reqs),
                  "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                  "p95_ms": float(np.percentile(lats, 95)) * 1e3,
                  "p99_ms": float(np.percentile(lats, 99)) * 1e3,
                  "mean_batch": float(np.mean(sizes)),
                  "utilization": util, "window_ms": args.window,
                  "dtype": args.dtype, "graphs": engine.graphs,
                  "backend": device.type, "tf32": tf32_enabled(),
                  "device": name,
                  "power_limit": limit}
        print(json.dumps(record))
        records.append(record)
    return records


if __name__ == "__main__":
    main()
