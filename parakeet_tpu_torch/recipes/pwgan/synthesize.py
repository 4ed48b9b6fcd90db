"""Parallel WaveGAN batch synthesis in the port: normalized mel .npy ->
waveform (counterpart of ``recipes/pwgan/synthesize.py``; reference:
examples/parallelwave_gan/baker/synthesize.py).

Each row of ``--test-metadata`` (``normalize.py``'s output) names its
``feats``; the mel is cut or zero-padded to ``--max-frames`` frames (the
JAX CLI's static length), vocoded whole by the generator (kernel K1 on
the card with the YAML's ``stack_impl: pallas``, eagerly) on the same
noise for every row (a generator seeded 0, the JAX CLI's fixed key; the
streams differ), and the wav is cut to the row's frames.

TF32 is off.  Each row prints its frames and the vocoder's host-clock
time (synchronised); ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.pwgan.synthesize \\
      --config recipes/pwgan/conf/default.yaml \\
      --checkpoint exp/checkpoints/snapshot_iter_N.npz \\
      --test-metadata dump_norm/dev/metadata.jsonl --output-dir wavs \\
      [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import save_wav
from ...data.datatable import read_jsonl
from ...training import Config
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..fastspeech2.synthesize_e2e import PaddedVocoder, build_vocoder
from ..synthesis import Stopwatch

__all__ = ["main"]


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"sample_rate", "lines": [{utt_id, frames, samples, vocoder_s, path,
    wav}], "vocoder": the ``PaddedVocoder``}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--test-metadata", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-frames", type=int, default=1024,
                        help="mel frames are padded to this static length")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    fs = Config.from_yaml(args.config).fs
    vocoder = PaddedVocoder(build_vocoder(args.config, args.checkpoint,
                                          device), args.max_frames)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for row in read_jsonl(args.test_metadata):
        mel = (np.load(row["feats"]) if isinstance(row["feats"], str)
               else np.asarray(row["feats"], np.float32))
        clock = Stopwatch(device)
        wav, n = vocoder(mel)
        vocoder_s = clock.seconds()
        out = args.output_dir / f"{row['utt_id']}.wav"
        save_wav(out, wav, fs)
        lines.append({"utt_id": row["utt_id"], "frames": n,
                      "samples": len(wav), "vocoder_s": vocoder_s,
                      "path": str(out), "wav": wav})
        print(f"{row['utt_id']}: {n} frames -> {out} (vocoder "
              f"{1e3 * vocoder_s:.1f} ms)")
    return {"sample_rate": fs, "lines": lines, "vocoder": vocoder}


if __name__ == "__main__":
    main()
