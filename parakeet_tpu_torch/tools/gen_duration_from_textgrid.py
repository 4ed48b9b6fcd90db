"""CLI: MFA TextGrid alignments -> the durations file that the recipes'
``preprocess.py`` reads (counterpart of
``tools/gen_duration_from_textgrid.py``).

Walks ``<inputdir>/<speaker>/*.TextGrid`` and writes one ``utt|spk|phn
dur ...`` line an utterance, whose durations sum to the mel frame count
at ``--fs``/``--n-shift`` (``data/textgrid.py``).

Usage:
  python -m parakeet_tpu_torch.tools.gen_duration_from_textgrid \\
      --inputdir aligned_textgrids/ --output durations.txt \\
      --fs 24000 --n-shift 300
"""
import argparse
from pathlib import Path

from ..data.textgrid import gen_duration_from_textgrid

__all__ = ["main"]


def main(argv=None) -> int:
    """Write the durations file; returns its line count."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inputdir", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--fs", type=int, default=24000)
    parser.add_argument("--n-shift", type=int, default=300)
    args = parser.parse_args(argv)
    gen_duration_from_textgrid(args.inputdir, args.output,
                               sample_rate=args.fs, n_shift=args.n_shift)
    n = len(args.output.read_text().splitlines())
    print(f"wrote {n} utterances to {args.output}")
    return n


if __name__ == "__main__":
    main()
