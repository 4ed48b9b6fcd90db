"""AISHELL-3 transcript G2P of the port (counterpart of
``recipes/tacotron2_aishell3/chinese_g2p.py``; reference:
examples/tacotron2_aishell3/chinese_g2p.py:29 +
preprocess_transcription.py): parses the AISHELL-3
``label_train-set.txt`` pinyin transcriptions into phones through the
port's copy of the rule-generated lexicon, and writes ``metadata.jsonl``
rows {utt_id, spk, text (phone ids), speech[, spk_emb]} plus the phone
vocabulary, ``phone_id_map.txt``.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2_aishell3.chinese_g2p \\
      --transcription train/label_train-set.txt --mel-root dump/mel \\
      --embed-root dump/ge2e_embeds --output-dir dump
"""
import argparse
import json
from pathlib import Path

from ...frontend.generate_lexicon import generate_lexicon
from ...frontend.vocab import Vocab


def parse_label_line(line: str):
    """'SSB00050001|words|pin1 yin1 ...' or whitespace AISHELL-3 format."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "|" in line:
        parts = line.split("|")
        utt_id, pinyin = parts[0].strip(), parts[-1].strip()
    else:
        utt_id, *rest = line.split()
        pinyin = " ".join(p for p in rest if not any(
            "一" <= ch <= "鿿" for ch in p))
    sylls = [s for s in pinyin.split() if s and s[-1].isdigit()]
    return utt_id, sylls


def main(argv=None):
    """Run the conversion with ``argv`` (default: the command line)."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--transcription", type=Path, required=True)
    parser.add_argument("--mel-root", type=Path, required=True)
    parser.add_argument("--embed-root", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, required=True)
    args = parser.parse_args(argv)

    lexicon = generate_lexicon(with_tone=True, with_erhua=True)
    phones = set()
    rows = []
    skipped = 0
    for line in open(args.transcription, encoding="utf-8"):
        parsed = parse_label_line(line)
        if parsed is None:
            continue
        utt_id, sylls = parsed
        try:
            phone_seq = []
            for s in sylls:
                phone_seq.extend(lexicon[s].split())
        except KeyError:
            skipped += 1
            continue
        spk = utt_id[:7]  # SSBxxxx speaker prefix
        mel_path = args.mel_root / spk / f"{utt_id}.npy"
        if not mel_path.exists():
            skipped += 1
            continue
        row = {"utt_id": utt_id, "spk": spk, "phones": phone_seq,
               "speech": str(mel_path)}
        if args.embed_root is not None:
            emb = args.embed_root / spk / f"{utt_id}.npy"
            if not emb.exists():
                skipped += 1
                continue
            row["spk_emb"] = str(emb)
        phones.update(phone_seq)
        rows.append(row)

    vocab = Vocab(sorted(phones))
    args.output_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = args.output_dir / "phone_id_map.txt"
    with open(vocab_path, "w", encoding="utf-8") as f:
        for symbol, idx in vocab.stoi.items():
            f.write(f"{symbol} {idx}\n")

    meta_path = args.output_dir / "metadata.jsonl"
    with open(meta_path, "w", encoding="utf-8") as f:
        for row in rows:
            row["text"] = [vocab.lookup(p) for p in row.pop("phones")]
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    print(f"{len(rows)} utterances -> {meta_path} "
          f"({skipped} skipped, {len(vocab)} phones)")


if __name__ == "__main__":
    main()
