"""SpeedySpeech feature normalization in the port (counterpart of
``recipes/speedyspeech/normalize.py``, whose steps it copies): z-score the
mel features.

Equivalent of the reference stage (reference:
examples/speedyspeech/baker/normalize.py): compute per-dim mean/std of
``feats`` over the TRAIN metadata (``--compute-stats``), write
``feats_stats.npy``, then rewrite metadata with normalized features
(phone/tone ids are already numeric from preprocess.py).  Host code;
nothing runs on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.speedyspeech.normalize \\
      --metadata dump/metadata_train.jsonl --dumpdir dump/norm/train \\
      --stats-dir dump --compute-stats
"""
import argparse
from pathlib import Path

from ...data.datatable import read_jsonl, write_jsonl
from ..fastspeech2.normalize import field_stats, normalized

__all__ = ["main"]


def main(argv=None) -> list:
    """Normalize with ``argv`` (default: the command line); returns the
    metadata rows written."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--metadata", type=Path, required=True)
    parser.add_argument("--dumpdir", type=Path, required=True)
    parser.add_argument("--stats-dir", type=Path, default=None)
    parser.add_argument("--compute-stats", action="store_true")
    args = parser.parse_args(argv)

    records = read_jsonl(args.metadata)
    args.dumpdir.mkdir(parents=True, exist_ok=True)
    stats_dir = args.stats_dir or args.dumpdir.parent
    stats_dir.mkdir(parents=True, exist_ok=True)
    mean, std = field_stats(records, "feats", stats_dir / "feats_stats.npy",
                            args.compute_stats)

    out_records = [{**r, "feats": normalized(r["feats"], args.dumpdir, mean,
                                             std)} for r in records]
    write_jsonl(args.dumpdir / "metadata.jsonl", out_records)
    print(f"normalized {len(out_records)} utterances -> {args.dumpdir}")
    return out_records


if __name__ == "__main__":
    main()
