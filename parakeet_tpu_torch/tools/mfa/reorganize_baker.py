"""Reorganize the Baker (BZNSYP) corpus for the Montreal Forced Aligner
(counterpart of ``tools/mfa/reorganize_baker.py``): copy or 16 kHz-resample
every wav (``audio/codec.py``) and write one ``<utt>.lab`` per utterance
with the tone-stripped pinyin transcription (tones are dropped because
the simple MFA lexicon is toneless; use --with-tone with a toned lexicon).

Usage:
  python -m parakeet_tpu_torch.tools.mfa.reorganize_baker \\
      --root-dir ~/datasets/BZNSYP --output-dir exp/baker_corpus \\
      [--resample-audio] [--with-tone]
"""
import argparse
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ...audio.codec import load_wav, save_wav

__all__ = ["get_transcripts", "resample_wav", "reorganize_baker", "main"]


def get_transcripts(path: Path, keep_tone: bool) -> dict:
    """ProsodyLabeling/000001-010000.txt: id+text line, pinyin line."""
    transcripts = {}
    lines = path.read_text(encoding="utf-8").splitlines()
    for i in range(0, len(lines) - 1, 2):
        sentence_id = lines[i].split()[0]
        syllables = lines[i + 1].strip().split()
        if not keep_tone:
            syllables = [s[:-1] if s and s[-1].isdigit() else s
                         for s in syllables]
        transcripts[sentence_id] = " ".join(syllables)
    return transcripts


def resample_wav(src: Path, dst: Path, sr: int = 16000) -> None:
    """``src`` read at ``sr`` (polyphase resampling) and written as 16-bit
    PCM to ``dst``."""
    wav, _ = load_wav(src, sr=sr)
    save_wav(dst, wav, sr)


def reorganize_baker(root_dir: Path, output_dir: Path,
                     resample_audio: bool, keep_tone: bool) -> None:
    transcripts = get_transcripts(
        root_dir / "ProsodyLabeling" / "000001-010000.txt", keep_tone)
    wave_dir = root_dir / "Wave"
    if wave_dir.resolve() == output_dir.resolve():
        raise ValueError("output_dir must differ from the Wave directory")
    output_dir.mkdir(parents=True, exist_ok=True)
    wav_paths = sorted(wave_dir.glob("*.wav"))
    if resample_audio:
        with ThreadPoolExecutor() as pool:
            list(pool.map(lambda p: resample_wav(p, output_dir / p.name),
                          wav_paths))
    else:
        for p in wav_paths:
            shutil.copyfile(p, output_dir / p.name)
    for sentence_id, transcript in transcripts.items():
        (output_dir / f"{sentence_id}.lab").write_text(
            transcript + "\n", encoding="utf-8")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root-dir", type=Path, required=True,
                        help="path to BZNSYP")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--resample-audio", action="store_true",
                        help="resample wavs to 16 kHz instead of copying")
    parser.add_argument("--with-tone", action="store_true",
                        help="keep tone digits in the .lab pinyin")
    args = parser.parse_args(argv)
    reorganize_baker(args.root_dir.expanduser(),
                     args.output_dir.expanduser(),
                     args.resample_audio, args.with_tone)
    print(f"Done. MFA corpus at {args.output_dir}")


if __name__ == "__main__":
    main()
