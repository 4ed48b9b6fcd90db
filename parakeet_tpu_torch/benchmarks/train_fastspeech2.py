"""FastSpeech2 training-throughput benchmark of the port (counterpart of
``benchmarks/train_fastspeech2.py``; reference: the trainer's ``avg_ips``
log line, parakeet/training/trainer.py:160-168).

Runs N training steps of the default-config FastSpeech2 (adim 384, 4
heads, 4 + 4 layers, Adam 1e-4) with flax's default initializers
drawn from seed 0 on one synthetic batch of the JAX bench's shape and
values (B text tokens and frames, every utterance full length, durations
frames // text_len), and prints one JSON line: ``value = batch_size /
avg_batch_cost`` in sequences per second under the JAX bench's metric
name ``fastspeech2_train_avg_ips``, with the attention core, the backend
and the card's name.  'flash' and 'auto' set the attention dropout rates
to 0, as the JAX bench does.  The steps are chained and timed from the
host after one warm-up step, with one synchronisation at the end.

Usage:
  python -m parakeet_tpu_torch.benchmarks.train_fastspeech2 \\
      [--iters 20] [--batch-size 32] [--text-len 96] [--frames 640] \\
      [--attn-impl dense|flash|auto] [--aheads 4] \\
      [--dtype float32|bfloat16] [--profile DIR] [--device cpu]

``--dtype bfloat16`` is flax's mixed precision: float32 parameters and
Adam state, bf16 products (``nn/precision.py``).  ``--aheads 2`` gives
the recipes' head width, 192.  Not ported from the JAX bench: ``--rng
rbg`` (a TPU device generator switch), refused with a message, and the
MFU fields (their denominator needs a training FLOP count of the port).
"""
import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import FastSpeech2, init_fs2_train_state, make_fs2_train_step
from ..nn.initializer import init_flax_defaults_
from ..training import build_optimizer, resolve_model_kwargs, seed_everything
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)

__all__ = ["main", "build_train_step"]

ODIM = 80


def build_train_step(batch_size: int, text_len: int, frames: int,
                     attn_impl: str, device: torch.device, aheads: int = 4,
                     dtype: Optional[torch.dtype] = None):
    """(step, state, batch) of the bench's model, computing in flax's
    ``dtype`` (None: float32), and batch."""
    kwargs = {"attn_impl": attn_impl, "dtype": dtype}
    if attn_impl in ("flash", "auto"):
        kwargs.update(transformer_enc_attn_dropout_rate=0.0,
                      transformer_dec_attn_dropout_rate=0.0)
    model = FastSpeech2(idim=80, odim=ODIM, adim=384, aheads=aheads,
                        elayers=4, eunits=1536, dlayers=4, dunits=1536,
                        **kwargs)
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model.to(device)
    b, t = batch_size, text_len
    rng = np.random.default_rng(0)
    durations = np.full((b, t), frames // t, np.int64)
    durations[:, -1] += frames - durations[0].sum()
    batch = {
        "text": rng.integers(1, 80, (b, t)),
        "text_lengths": np.full(b, t),
        "speech": rng.standard_normal((b, frames, ODIM)).astype(np.float32),
        "speech_lengths": np.full(b, frames),
        "durations": durations,
        "pitch": rng.standard_normal((b, t, 1)).astype(np.float32),
        "energy": rng.standard_normal((b, t, 1)).astype(np.float32)}
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    opt = build_optimizer(model.parameters(), "adam", 1e-4)
    state = init_fs2_train_state(model, opt,
                                 seed_everything(0, device=device))
    return make_fs2_train_step(model, opt), state, batch


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--text-len", type=int, default=96)
    parser.add_argument("--frames", type=int, default=640)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype (bfloat16: float32 parameters)")
    parser.add_argument("--aheads", type=int, default=4,
                        help="attention heads over adim 384 (2: the "
                             "recipes' head width 192)")
    parser.add_argument("--attn-impl", default="dense",
                        choices=("dense", "flash", "auto"),
                        help="attention core; 'flash' runs kernel K4 and "
                             "skips attention-weight dropout, so the "
                             "attention dropout rates are set to 0")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace (.json) and its "
                             "table by kernel (.txt) of 3 steps into DIR")
    parser.add_argument("--rng", default="threefry",
                        choices=("threefry", "rbg"),
                        help="the JAX bench's device generator; 'rbg' is "
                             "the TPU's and is refused")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.rng != "threefry":
        raise NotImplementedError("--rng rbg is a TPU device generator; "
                                  "the port draws from a torch.Generator")
    dtype = resolve_model_kwargs({"dtype": args.dtype}).get("dtype")
    device = set_device(args.device)
    disable_tf32()
    step, state, batch = build_train_step(args.batch_size, args.text_len,
                                          args.frames, args.attn_impl,
                                          device, args.aheads, dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, metrics = step(state, batch)            # warm-up
    float(metrics["loss"])
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                state, metrics = step(state, batch)
            sync()
        name = out / f"train_fastspeech2_{args.attn_impl}"
        prof.export_chrome_trace(f"{name}.json")
        sort = ("cuda_time_total" if device.type == "cuda"
                else "cpu_time_total")
        Path(f"{name}.txt").write_text(prof.key_averages().table(
            sort_by=sort, row_limit=30))
    sync()
    tic = time.perf_counter()
    for _ in range(args.iters):
        state, metrics = step(state, batch)
    float(metrics["loss"])                          # waits for the device
    sync()
    avg_batch_cost = (time.perf_counter() - tic) / args.iters
    record = {"metric": "fastspeech2_train_avg_ips",
              "batch_size": args.batch_size,
              "value": args.batch_size / avg_batch_cost,
              "unit": "sequences/sec", "dtype": args.dtype,
              "attn_impl": args.attn_impl, "aheads": args.aheads,
              "backend": device.type,
              "tf32": tf32_enabled(),
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
