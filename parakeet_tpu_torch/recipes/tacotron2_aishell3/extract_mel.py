"""AISHELL-3 mel extraction for voice cloning, in the port (counterpart of
``recipes/tacotron2_aishell3/extract_mel.py``; reference:
examples/tacotron2_aishell3/extract_mel.py:15): for every speaker
directory of wavs, write peak-normalised natural-log mel .npy features
used to train the GE2E-conditioned Tacotron2, through the port's copy of
``audio/`` on the host.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2_aishell3.extract_mel \\
      --input data_aishell3/train/wav --output dump/mel --fs 22050
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import LogMelFBank
from ...utils.mp_tools import thread_map


def main(argv=None):
    """Run the extraction with ``argv`` (default: the command line)."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", type=Path, required=True,
                        help="root with one subdirectory per speaker")
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--fs", type=int, default=22050)
    parser.add_argument("--n-fft", type=int, default=1024)
    parser.add_argument("--hop-length", type=int, default=256)
    parser.add_argument("--win-length", type=int, default=1024)
    parser.add_argument("--n-mels", type=int, default=80)
    parser.add_argument("--fmin", type=int, default=0)
    parser.add_argument("--fmax", type=int, default=8000)
    parser.add_argument("--num-workers", type=int, default=8)
    args = parser.parse_args(argv)

    mel = LogMelFBank(sr=args.fs, n_fft=args.n_fft,
                      hop_length=args.hop_length,
                      win_length=args.win_length, n_mels=args.n_mels,
                      fmin=args.fmin, fmax=args.fmax)
    speakers = [d for d in sorted(args.input.iterdir()) if d.is_dir()]

    def process(spk_dir):
        out_dir = args.output / spk_dir.name
        out_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for path in sorted(spk_dir.rglob("*.wav")):
            wav, _ = load_wav(path, sr=args.fs)
            peak = np.abs(wav).max()
            if peak > 0:
                wav = wav / peak * 0.999
            feats = mel.get_log_mel_fbank(wav, base="e")
            np.save(out_dir / f"{path.stem}.npy", feats.astype(np.float32))
            n += 1
        return f"{spk_dir.name}: {n}"

    for msg in thread_map(process, speakers, args.num_workers):
        print(msg)


if __name__ == "__main__":
    main()
