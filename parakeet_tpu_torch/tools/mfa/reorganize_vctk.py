"""Reorganize VCTK-0.92 for the Montreal Forced Aligner (counterpart of
``tools/mfa/reorganize_vctk.py``): keep only the mic2 takes (mic1 has
low-frequency noise), skip speakers without text (p315) or without mic2
(p280, p362), resample flac/wav to 16 kHz PCM (``audio/codec.py``; flac
needs the optional soundfile package), and copy the per-speaker
transcription .txt files to .lab.

Usage:
  python -m parakeet_tpu_torch.tools.mfa.reorganize_vctk \\
      --root-dir ~/datasets/VCTK-Corpus-0.92 --output-dir exp/vctk_corpus
"""
import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .reorganize_baker import resample_wav

__all__ = ["SKIP_SPEAKERS", "write_wav", "write_label", "main"]

SKIP_SPEAKERS = {"log.txt", "p315", "p280", "p362"}


def write_wav(root_dir: Path, output_dir: Path) -> None:
    wav_dir = root_dir / "wav48_silence_trimmed"
    jobs = []
    for spk in sorted(os.listdir(wav_dir)):
        if spk in SKIP_SPEAKERS:
            continue
        sub_dir = wav_dir / spk
        new_sub = output_dir / spk
        new_sub.mkdir(parents=True, exist_ok=True)
        for name in sorted(os.listdir(sub_dir)):
            if "mic2" not in name:
                continue
            utt = "_".join(name.split("_")[:2])
            jobs.append((sub_dir / name, new_sub / f"{utt}.wav"))
    with ThreadPoolExecutor() as pool:
        list(pool.map(lambda j: resample_wav(*j), jobs))


def write_label(root_dir: Path, output_dir: Path) -> None:
    txt_dir = root_dir / "txt"
    for spk in sorted(os.listdir(txt_dir)):
        if spk in SKIP_SPEAKERS:
            continue
        new_sub = output_dir / spk
        new_sub.mkdir(parents=True, exist_ok=True)
        for txt in sorted((txt_dir / spk).glob("*.txt")):
            (new_sub / (txt.stem + ".lab")).write_text(
                txt.read_text(encoding="utf-8").strip() + "\n",
                encoding="utf-8")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root-dir", type=Path, required=True,
                        help="path to VCTK-Corpus-0.92")
    parser.add_argument("--output-dir", type=Path, required=True)
    args = parser.parse_args(argv)
    root, out = args.root_dir.expanduser(), args.output_dir.expanduser()
    out.mkdir(parents=True, exist_ok=True)
    write_wav(root, out)
    write_label(root, out)
    print(f"Done. MFA corpus at {out}")


if __name__ == "__main__":
    main()
