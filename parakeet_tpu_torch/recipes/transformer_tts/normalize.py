"""Z-score speech features + phone-id mapping for TransformerTTS (and
Tacotron2), in the port (counterpart of
``recipes/transformer_tts/normalize.py``, whose steps it copies).

Equivalent of the reference recipe stage (reference:
examples/transformer_tts/normalize.py:28-140): per-dim mean/std of
``speech`` over the TRAIN metadata -> speech_stats.npy
(``--compute-stats``), then rewrite each split with normalized features
and text ids (the model itself appends <eos>).  Host code; nothing runs
on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.transformer_tts.normalize \\
      --metadata dump/metadata_train.jsonl --dumpdir dump_norm/train \\
      --phones-dict dump/phone_id_map.txt --stats-dir dump --compute-stats
"""
import argparse
from pathlib import Path

from ...data.datatable import read_jsonl, write_jsonl
from ...data.preprocess import load_id_map
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
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--stats-dir", type=Path, default=None)
    parser.add_argument("--compute-stats", action="store_true")
    args = parser.parse_args(argv)

    records = read_jsonl(args.metadata)
    args.dumpdir.mkdir(parents=True, exist_ok=True)
    stats_dir = args.stats_dir or args.dumpdir.parent
    stats_dir.mkdir(parents=True, exist_ok=True)
    mean, std = field_stats(records, "speech",
                            stats_dir / "speech_stats.npy",
                            args.compute_stats)

    phone_map = load_id_map(args.phones_dict)
    unk = phone_map.get("<unk>", 1)
    out_records = [{**r, "speech": normalized(r["speech"], args.dumpdir,
                                              mean, std),
                    "text": [phone_map.get(p, unk) for p in r["phones"]]}
                   for r in records]
    write_jsonl(args.dumpdir / "metadata.jsonl", out_records)
    print(f"normalized {len(out_records)} utterances -> {args.dumpdir}")
    return out_records


if __name__ == "__main__":
    main()
