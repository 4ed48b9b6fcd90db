"""Batched end-to-end serving throughput of the port (counterpart of
``benchmarks/serving_throughput.py``): FastSpeech2 + Parallel WaveGAN.

``e2e_rtf`` measures the batch-1 RTF; a server batches concurrent
requests instead.  This is the fixed-shape capacity ceiling: the same
program at batch ``--batch-size`` (every row ``--text-len`` phone ids, a
capacity of ``--max-frames`` frames), one CUDA graph on the card, timed
as ``e2e_rtf`` times it.  Prints one JSON line: generated audio-seconds
per wall second (``value``), the per-stream RTF, MFU against the card's
bf16 peak, the graph's and the eager program's times, the card's name and
power limit.

Usage:
  python -m parakeet_tpu_torch.benchmarks.serving_throughput
      [--batch-size 8] [--iters 10] [--text-len 128] [--max-frames 896]
      [--dtype float32] [--device cpu]
"""
import argparse
import json

from ..utils.device import add_device_arg, disable_tf32, set_device
from .common import DTYPES
from .e2e_rtf import run

__all__ = ["main"]


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--text-len", type=int, default=128)
    parser.add_argument("--max-frames", type=int, default=896)
    parser.add_argument("--dtype", default="float32", choices=DTYPES)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    disable_tf32()
    res = run(dtype=args.dtype, attn_impl="auto",
              device=set_device(args.device), iters=args.iters,
              batch=args.batch_size, text_len=args.text_len,
              max_frames=args.max_frames)
    record = {"metric": "fastspeech2_pwgan_serving_throughput",
              "batch_size": args.batch_size,
              "value": res["audio_seconds"] / res["seconds"],
              "unit": "audio_seconds/sec", "per_stream_rtf": res["rtf"],
              **{k: v for k, v in res.items() if k != "rtf"}}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
