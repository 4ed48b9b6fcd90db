"""Long-form (paragraph-scale) end-to-end synthesis RTF of the port
(counterpart of ``benchmarks/longform_rtf.py``).

A 512-phone paragraph expanded to ``--frames`` decoder frames (6,144 by
default: 1,843,200 samples, 76.8 s of 24 kHz audio; every phone lasts at
least ``frames // 512`` frames, so the paragraph fills the capacity)
through ``bench.py``'s FastSpeech2 and one-shot Parallel WaveGAN
vocoding, one CUDA graph per attention core: 'dense', and 'auto', which
takes kernel K4a at dk 96 from 512 frames on.  Timed as ``e2e_rtf``
times it; one JSON line per core.

Usage:
  python -m parakeet_tpu_torch.benchmarks.longform_rtf [--iters 5]
      [--frames 6144] [--attn-impls dense auto] [--dtype float32]
      [--device cpu]
"""
import argparse
import json

from ..utils.device import add_device_arg, disable_tf32, set_device
from .common import DTYPES
from .e2e_rtf import run

__all__ = ["main"]

TEXT_LEN = 512


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--frames", type=int, default=6144)
    parser.add_argument("--attn-impls", nargs="+", default=["dense", "auto"],
                        choices=("auto", "dense", "flash"))
    parser.add_argument("--dtype", default="float32", choices=DTYPES)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    records = []
    for impl in args.attn_impls:
        res = run(dtype=args.dtype, attn_impl=impl, device=device,
                  iters=args.iters, batch=1, text_len=TEXT_LEN,
                  max_frames=args.frames,
                  min_duration=args.frames // TEXT_LEN)
        if res["frame_lengths"] != [args.frames]:
            raise AssertionError(f"{impl}: frame lengths "
                                 f"{res['frame_lengths']}, not "
                                 f"[{args.frames}]")
        record = {"metric": "fastspeech2_pwgan_longform_rtf",
                  "value": res.pop("rtf"), "unit": "rtf",
                  "frames": args.frames, **res}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
