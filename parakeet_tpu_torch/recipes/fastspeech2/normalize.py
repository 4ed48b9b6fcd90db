"""Z-score feature normalization + id mapping for FastSpeech2, in the port
(counterpart of ``recipes/fastspeech2/normalize.py``, whose steps it
copies).

Equivalent of the reference recipe stages (reference:
examples/fastspeech2/normalize.py + utils/compute_statistics.py:14):
compute per-dim mean/std of speech/pitch/energy over the TRAIN metadata
(``--compute-stats``), write ``*_stats.npy``, then rewrite metadata with
normalized feature files, phone ids and, with ``--speaker-dict``, speaker
ids.  Host code; nothing runs on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.normalize \\
      --metadata dump/metadata_train.jsonl --dumpdir dump_norm/train \\
      --phones-dict dump/phone_id_map.txt --stats-dir dump --compute-stats
"""
import argparse
from pathlib import Path

import numpy as np

from ...data.datatable import read_jsonl, write_jsonl
from ...data.preprocess import RunningStats, load_id_map

__all__ = ["main", "compute_stats", "field_stats"]


def compute_stats(records, field, dim):
    stats = RunningStats(dim)
    for r in records:
        stats.update(np.load(r[field]))
    return stats


def field_stats(records, field, path: Path, compute: bool, dim=None):
    """(mean, std) of ``field``: computed over ``records`` and written to
    ``path`` when ``compute`` (the train split), else read from it; a
    missing file raises ``SystemExit``."""
    if compute:
        d = dim or np.load(records[0][field]).shape[-1]
        s = compute_stats(records, field, d)
        np.save(path, np.stack([s.mean, s.std]))
    elif not path.exists():
        raise SystemExit(
            f"stats file {path} not found — normalize the TRAIN split "
            "first with --compute-stats (dev/test must reuse the train "
            "statistics)")
    arr = np.load(path)
    return arr[0], arr[1]


def normalized(path, out_dir: Path, mean, std) -> str:
    """Save ``(load(path) - mean) / max(std, 1e-8)`` in float32 under
    ``out_dir`` with the same file name; returns its path."""
    x = (np.load(path) - mean) / np.maximum(std, 1e-8)
    out = out_dir / Path(path).name
    np.save(out, x.astype(np.float32))
    return str(out)


def main(argv=None) -> list:
    """Normalize with ``argv`` (default: the command line); returns the
    metadata rows written."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--metadata", type=Path, required=True)
    parser.add_argument("--dumpdir", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--speaker-dict", type=Path, default=None)
    parser.add_argument("--stats-dir", type=Path, default=None,
                        help="where to read/write *_stats.npy "
                             "(default: --dumpdir parent)")
    parser.add_argument("--compute-stats", action="store_true",
                        help="compute stats from this metadata (train)")
    args = parser.parse_args(argv)

    records = read_jsonl(args.metadata)
    args.dumpdir.mkdir(parents=True, exist_ok=True)
    stats_dir = args.stats_dir or args.dumpdir.parent
    stats_dir.mkdir(parents=True, exist_ok=True)

    fields = [("speech", None), ("pitch", 1), ("energy", 1)]
    stats = {field: field_stats(records, field,
                                stats_dir / f"{field}_stats.npy",
                                args.compute_stats, dim)
             for field, dim in fields}

    phone_map = load_id_map(args.phones_dict)
    spk_map = (load_id_map(args.speaker_dict)
               if args.speaker_dict else None)

    out_records = []
    for r in records:
        new = dict(r)
        for field, _ in fields:
            new[field] = normalized(r[field], args.dumpdir, *stats[field])
        new["text"] = [phone_map.get(p, phone_map.get("<unk>", 1))
                       for p in r["phones"]]
        if spk_map is not None:
            new["spk_id"] = spk_map[r["speaker"]]
        out_records.append(new)

    write_jsonl(args.dumpdir / "metadata.jsonl", out_records)
    print(f"normalized {len(out_records)} utterances -> {args.dumpdir}")
    return out_records


if __name__ == "__main__":
    main()
