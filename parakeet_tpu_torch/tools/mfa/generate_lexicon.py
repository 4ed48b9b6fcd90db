"""Write a rule-generated pinyin -> phones lexicon for MFA training
(counterpart of ``tools/mfa/generate_lexicon.py``, on
``frontend/generate_lexicon.py``).

Usage:
  python -m parakeet_tpu_torch.tools.mfa.generate_lexicon exp/simple \\
      [--with-tone] [--with-r]
writes ``exp/simple.lexicon`` with one "syllable phone phone..." row per
pinyin syllable.
"""
import argparse
from pathlib import Path

from ...frontend.generate_lexicon import generate_lexicon

__all__ = ["main"]


def main(argv=None) -> Path:
    """Write the lexicon; returns its path."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("output", type=Path,
                        help="output path stem (suffix .lexicon is added)")
    parser.add_argument("--with-tone", action="store_true",
                        help="tone-numbered syllables and finals")
    parser.add_argument("--with-r", action="store_true",
                        help="include erhua (r-coloured) syllables")
    args = parser.parse_args(argv)

    lex = generate_lexicon(with_tone=args.with_tone,
                           with_erhua=args.with_r)
    out = args.output.with_suffix(".lexicon")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wt", encoding="utf-8") as f:
        for syllable, phones in lex.items():
            f.write(f"{syllable} {phones}\n")
    print(f"wrote {len(lex)} entries to {out}")
    return out


if __name__ == "__main__":
    main()
