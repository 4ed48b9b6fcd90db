"""Z-score the vocoder mel features with TRAIN-set statistics, in the port
(counterpart of ``recipes/pwgan/normalize.py``, whose steps it copies).

Equivalent of the reference pipeline's compute_statistics + normalize
stages (reference: utils/compute_statistics.py, examples/GANVocoder/
normalize.py:28-133): compute per-dim mean/std of ``feats`` over the
train metadata once, write ``feats_stats.npy`` ([mean, std] stack), then
rewrite each split with normalized feature files.  The same stats file
feeds synthesis-time denormalization and wav copy-synthesis
(``synthesize_from_wav.py``).  Host code; nothing runs on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.pwgan.normalize \\
      --metadata dump/metadata_train.jsonl --dumpdir dump_norm/train \\
      --stats dump/feats_stats.npy --compute-stats      # train split
  python -m parakeet_tpu_torch.recipes.pwgan.normalize \\
      --metadata dump/metadata_dev.jsonl --dumpdir dump_norm/dev \\
      --stats dump/feats_stats.npy                      # reuse
"""
import argparse
from pathlib import Path

import numpy as np

from ...data.datatable import read_jsonl, write_jsonl
from ...data.preprocess import RunningStats

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
    parser.add_argument("--stats", type=Path, required=True,
                        help="feats_stats.npy path (written with "
                             "--compute-stats, read otherwise)")
    parser.add_argument("--compute-stats", action="store_true",
                        help="compute stats from this metadata (train)")
    parser.add_argument("--skip-wav-copy", action="store_true",
                        help="keep metadata pointing at the raw wave "
                             "files instead of copying them")
    args = parser.parse_args(argv)

    records = read_jsonl(args.metadata)
    args.dumpdir.mkdir(parents=True, exist_ok=True)

    if args.compute_stats:
        stats = RunningStats(np.load(records[0]["feats"]).shape[-1])
        for r in records:
            stats.update(np.load(r["feats"]))
        args.stats.parent.mkdir(parents=True, exist_ok=True)
        np.save(args.stats, np.stack([stats.mean, stats.std]))
    elif not args.stats.exists():
        raise SystemExit(
            f"stats file {args.stats} not found — normalize the TRAIN "
            "split first with --compute-stats (dev/test must reuse the "
            "train statistics)")
    arr = np.load(args.stats)
    mean, std = arr[0], np.maximum(arr[1], 1e-8)

    out_records = []
    for r in records:
        new = dict(r)
        mel = (np.load(r["feats"]) - mean) / std
        feats_path = args.dumpdir / Path(r["feats"]).name
        np.save(feats_path, mel.astype(np.float32))
        new["feats"] = str(feats_path)
        if not args.skip_wav_copy:
            wave_path = args.dumpdir / Path(r["wave"]).name
            np.save(wave_path, np.load(r["wave"]).astype(np.float32))
            new["wave"] = str(wave_path)
        out_records.append(new)

    write_jsonl(args.dumpdir / "metadata.jsonl", out_records)
    print(f"normalized {len(out_records)} utterances -> {args.dumpdir}")
    return out_records


if __name__ == "__main__":
    main()
