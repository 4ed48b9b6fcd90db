"""Generate a CMUdict-grounded English G2P eval set (counterpart of
``tools/make_cmudict_eval.py``, on ``frontend/_arpabet_data.py``).

Samples ground truth from a CMUdict file (``--cmudict``, e.g.
cmudict-0.7b; none ships with this repository) in three deterministic
strata (seeded sample):
- ``lexicon``: words the built-in lexicon covers directly;
- ``morph``: regularly-derived forms (plural/past/-ing/-ly/...) of
  built-in words that CMUdict lists but the lexicon does not;
- ``oov``: a uniform sample of the remaining CMUdict words.

Output line format: ``stratum|word|PH.. ;PH..`` (every CMUdict variant
pronunciation, ';'-separated), after the header the JAX tool writes:
the same bytes on the same dictionary and seed.

Usage:
  python -m parakeet_tpu_torch.tools.make_cmudict_eval \\
      --cmudict cmudict-0.7b [--out cases.txt] [--seed 0]
"""
import argparse
import random
import re
from pathlib import Path

from ..frontend._arpabet_data import BUILTIN_LEXICON

__all__ = ["load_cmudict", "derived_spellings", "main"]

_ENTRY = re.compile(r"^([A-Za-z'\-\.]+)(?:\((\d)\))?\s\s(.+?)\s*$")
DEFAULT_OUT = (Path(__file__).resolve().parents[2]
               / "recipes/text_frontend/data/en_g2p_cmudict_cases.txt")


def load_cmudict(path):
    """word -> [pronunciation, ...] of the lowercase alphabetic entries."""
    table = {}
    for raw in open(path, encoding="latin-1"):
        if raw.startswith(";;;"):
            continue
        m = _ENTRY.match(raw)
        if not m:
            continue
        word = m.group(1).lower()
        if not re.fullmatch(r"[a-z]+", word):
            continue
        table.setdefault(word, []).append(m.group(3))
    return table


def derived_spellings(word):
    """Candidate regular derived spellings of a base word (the suffix
    families ``frontend/arpabet.py``'s ``BuiltinLexiconG2P._derive``
    handles)."""
    out = {word + "s", word + "es"}
    if word.endswith("y") and len(word) > 2:
        out.update(word[:-1] + s for s in ("ies", "ied", "ier", "iest",
                                           "ily"))
    out.update(word + s for s in ("ed", "d", "ing"))
    if word.endswith("e"):
        out.update(word[:-1] + s for s in ("ing", "ed"))
    out.update(word + s for s in ("ly", "er", "est", "ness", "ment", "ful",
                                  "less"))
    out.discard(word)
    return out


def main(argv=None) -> Path:
    """Write the eval set; returns its path."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cmudict", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-lexicon", type=int, default=400)
    ap.add_argument("--n-morph", type=int, default=200)
    ap.add_argument("--n-oov", type=int, default=200)
    args = ap.parse_args(argv)

    cmu = load_cmudict(args.cmudict)
    rng = random.Random(args.seed)
    builtin = set(BUILTIN_LEXICON)

    lex_pool = sorted(builtin & set(cmu))
    morph_pool = sorted({d for w in builtin for d in derived_spellings(w)
                         if d in cmu and d not in builtin})
    oov_pool = sorted(set(cmu) - builtin - set(morph_pool))

    def pick(pool, n):
        return sorted(rng.sample(pool, min(n, len(pool))))

    rows = ([("lexicon", w) for w in pick(lex_pool, args.n_lexicon)]
            + [("morph", w) for w in pick(morph_pool, args.n_morph)]
            + [("oov", w) for w in pick(oov_pool, args.n_oov)])

    with open(args.out, "w", encoding="utf-8") as f:
        f.write(
            "# CMUdict-grounded en G2P eval set — generated by\n"
            "# tools/make_cmudict_eval.py (seed %d) from the reference's\n"
            "# carried cmudict-0.7b (examples/use_mfa/local/).  Ground\n"
            "# truth NOT authored in this repo (breaks the r3-flagged\n"
            "# label circularity).  Format: stratum|word|variants(';').\n"
            % args.seed)
        for stratum, w in rows:
            f.write("%s|%s|%s\n" % (stratum, w, ";".join(cmu[w])))
    counts = {s: sum(1 for t, _ in rows if t == s)
              for s in ("lexicon", "morph", "oov")}
    print("wrote %s: %s (pools: lexicon %d, morph %d, oov %d)"
          % (args.out, counts, len(lex_pool), len(morph_pool),
             len(oov_pool)))
    return args.out


if __name__ == "__main__":
    main()
