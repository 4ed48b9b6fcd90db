"""GE2E preprocessing of the port (counterpart of
``recipes/ge2e/preprocess.py``, whose pipeline it copies): speaker wav
trees -> per-speaker log-mel .npy utterances.

Equivalent of the reference pipeline (reference:
examples/ge2e/audio_processor.py:110-173 + preprocess.py): resample,
loudness-normalize, voice-activity trim, then write one (T, n_mels)
log-mel .npy per utterance under <output>/<speaker>/.  The host-side
audio comes from the port's copy of ``audio/``; nothing here runs on the
card.

The reference trims silence with webrtcvad (a C extension); this swaps
only the per-window speech decision for an energy gate and keeps the
reference's post-decision pipeline verbatim (moving average, rounding,
silence dilation).

``--dataset`` selects a corpus layout adapter (speaker-directory
discovery, glob pattern, "dataset_speaker" naming, VoxCeleb1's
anglophone filter) mirroring the reference dataset processors
(reference: examples/ge2e/dataset_processors.py:106-175).

Usage:
  python -m parakeet_tpu_torch.recipes.ge2e.preprocess \\
      --input datasets/LibriSpeech/train-clean-100 \\
      --output dump/ge2e_mels --pattern "*.flac|*.wav"
  python -m parakeet_tpu_torch.recipes.ge2e.preprocess \\
      --dataset librispeech_other --datasets-root ~/datasets \\
      --output dump/ge2e_mels
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import LogMelFBank
from ...utils.mp_tools import thread_map

INT16_MAX = 32767


def normalize_volume(wav, target_dbfs=-30.0):
    rms = np.sqrt(np.mean(wav ** 2) + 1e-12)
    dbfs = 20 * np.log10(rms + 1e-12)
    return wav * (10 ** ((target_dbfs - dbfs) / 20))


def vad_postprocess(voice_flags, moving_average_width=8,
                    max_silence_length=6):
    """Reference webrtcvad post-processing, ported exactly
    (audio_processor.py:90-106): zero-padded moving average over the
    per-window speech flags, round to bool, then binary-dilate with a
    ``ones(max_silence_length + 1)`` structuring element so short
    internal silences are bridged.  Returns the per-window keep mask."""
    w = moving_average_width
    arr = np.concatenate((np.zeros((w - 1) // 2),
                          np.asarray(voice_flags, float),
                          np.zeros(w // 2)))
    ret = np.cumsum(arr, dtype=float)
    ret[w:] = ret[w:] - ret[:-w]
    smoothed = ret[w - 1:] / w
    mask = np.round(smoothed).astype(bool)
    from scipy.ndimage import binary_dilation
    return binary_dilation(mask, np.ones(max_silence_length + 1))


def energy_vad(wav, fs, window_ms=30, moving_average_width=8,
               max_silence_length=6, threshold_db=-40.0):
    """Boolean sample mask standing in for the reference's webrtcvad
    trim (audio_processor.py:60-107).

    The per-window speech decision is an energy gate (webrtcvad's GMM
    classifier is a C extension; on clean corpora both reduce to "does
    the window contain signal energy").  Everything downstream of the
    per-window decision — moving-average smoothing, rounding, silence
    dilation, repeat-to-samples — is the reference pipeline ported
    verbatim (``vad_postprocess``)."""
    win = max(1, (window_ms * fs) // 1000)
    n = len(wav) // win
    if n == 0:
        return np.ones(len(wav), bool)
    frames = wav[:n * win].reshape(n, win)
    db = 10 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
    voiced = db > threshold_db
    mask = np.repeat(vad_postprocess(voiced, moving_average_width,
                                     max_silence_length), win)
    # the reference drops the sub-window tail entirely (wav is cut to a
    # multiple of the window before VAD); mask it out here instead.
    return np.pad(mask, (0, len(wav) - len(mask)), constant_values=False)


_ANGLOPHONE = ["australia", "canada", "ireland", "uk", "usa"]


def collect_speaker_dirs(dataset: str, root: Path):
    """Corpus layout adapters (reference dataset_processors.py:106-175).

    Returns (list of (speaker_name, dir), glob pattern); speaker_name
    joins the path parts below ``root`` so mixed corpora stay disjoint.
    """
    def named(dirs):
        return [("_".join(d.relative_to(root).parts), d)
                for d in sorted(dirs) if d.is_dir()]

    if dataset == "librispeech_other":
        return named((root / "LibriSpeech" / "train-other-500").glob("*")), \
            "*.flac"
    if dataset == "voxceleb1":
        base = root / "VoxCeleb1"
        with (base / "vox1_meta.csv").open() as f:
            meta = [line.strip().split("\t") for line in f][1:]
        keep = {row[0] for row in meta
                if row[-1] == "dev" and row[3].lower() in _ANGLOPHONE}
        dirs = [d for d in (base / "wav").glob("*") if d.name in keep]
        print(f"VoxCeleb1: {len(dirs)} anglophone dev speakers kept")
        return named(dirs), "*.wav"
    if dataset == "voxceleb2":
        return named((root / "VoxCeleb2" / "wav").glob("*")), "*.wav"
    if dataset == "aidatatang_200zh":
        return named((root / "aidatatang_200zh" / "corpus" /
                      "train").glob("*")), "*.wav"
    if dataset == "magicdata":
        return named((root / "magicdata" / "train").glob("*")), "*.wav"
    raise ValueError(f"unknown dataset {dataset!r}")


def main(argv=None):
    """Run the preprocessing with ``argv`` (default: the command line)."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", type=Path, default=None,
                        help="root with one subdirectory per speaker "
                             "(generic layout)")
    parser.add_argument("--dataset", default=None,
                        choices=("librispeech_other", "voxceleb1",
                                 "voxceleb2", "aidatatang_200zh",
                                 "magicdata"),
                        help="use a corpus layout adapter instead of "
                             "--input")
    parser.add_argument("--datasets-root", type=Path, default=None,
                        help="root containing the --dataset corpus")
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--pattern", default=None,
                        help="'|'-separated glob patterns (default: the "
                             "--dataset adapter's pattern, else *.wav)")
    parser.add_argument("--fs", type=int, default=16000)
    parser.add_argument("--n-mels", type=int, default=40)
    parser.add_argument("--window-ms", type=float, default=25.0)
    parser.add_argument("--hop-ms", type=float, default=10.0)
    parser.add_argument("--min-frames", type=int, default=160,
                        help="skip utterances shorter than this many "
                             "frames (partials_n_frames in the reference)")
    parser.add_argument("--num-workers", type=int, default=8)
    args = parser.parse_args(argv)

    win = int(args.fs * args.window_ms / 1000)
    hop = int(args.fs * args.hop_ms / 1000)
    mel = LogMelFBank(sr=args.fs, n_fft=512, hop_length=hop,
                      win_length=win, n_mels=args.n_mels, fmin=0,
                      fmax=args.fs // 2)

    if args.dataset is not None:
        if args.datasets_root is None:
            parser.error("--dataset requires --datasets-root")
        speakers, pattern = collect_speaker_dirs(args.dataset,
                                                 args.datasets_root)
        if args.pattern is None:
            args.pattern = pattern
    elif args.input is not None:
        speakers = [(d.name, d) for d in sorted(args.input.iterdir())
                    if d.is_dir()]
        if args.pattern is None:
            args.pattern = "*.wav"
    else:
        parser.error("one of --input / --dataset is required")

    def process_speaker(spk):
        spk_name, spk_dir = spk
        out_dir = args.output / spk_name
        out_dir.mkdir(parents=True, exist_ok=True)
        count = 0
        for pattern in args.pattern.split("|"):
            for path in sorted(spk_dir.rglob(pattern)):
                wav, _ = load_wav(path, sr=args.fs)
                wav = normalize_volume(wav)
                mask = energy_vad(wav, args.fs)
                wav = wav[mask]
                feats = mel.get_log_mel_fbank(wav, base="e")
                if feats.shape[0] < args.min_frames:
                    continue
                np.save(out_dir / f"{path.stem}.npy",
                        feats.astype(np.float32))
                count += 1
        return f"{spk_name}: {count} utterances"

    for msg in thread_map(process_speaker, speakers, args.num_workers):
        print(msg)


if __name__ == "__main__":
    main()
