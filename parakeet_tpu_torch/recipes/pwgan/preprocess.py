"""PWGAN preprocessing in the port (counterpart of
``recipes/pwgan/preprocess.py``, whose pipeline it copies): wavs ->
(wave, log-mel) pairs + metadata.

Equivalent of the reference vocoder preprocessing (reference:
examples/GANVocoder/preprocess.py:35-101): per-utterance log-mel stored
with the raw waveform for the random-window GAN collator, optional
MFA-duration-driven silence trimming (``--dur-file --cut-sil``), and the
wave padded/truncated so num_samples == num_frames * n_shift.
``--num-cpu N`` processes utterances in N worker processes.  Host code
(the port's copies of ``audio/`` and ``data/``); nothing runs on the card.

Writes ``<utt>_wave.npy``, ``<utt>_feats.npy`` and
``metadata_{dev,train}.jsonl`` (the first ``--dev-size`` utterances in
name order are dev) under ``--dumpdir``, as the JAX CLI does.

Usage:
  python -m parakeet_tpu_torch.recipes.pwgan.preprocess --rootdir wavs/ \\
      --dumpdir dump --config recipes/pwgan/conf/default.yaml \\
      [--dur-file durations.txt --cut-sil] [--dev-size 100] [--num-cpu 8]
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import cached_extractors
from ...data.datatable import write_jsonl
from ...data.preprocess import cut_silence, merge_silence, read_duration_file
from ...training import Config
from ..common import run_jobs

__all__ = ["main", "process_utterance"]


def process_utterance(utt, wav_path, sent, cfg, dumpdir):
    """One utterance's wave and log-mel files and its metadata row, or a
    message saying why it is skipped; ``sent`` = (phones, durations) to
    cut the silence with, or None."""
    mel_extractor, _, _ = cached_extractors(
        cfg.fs, cfg.n_fft, cfg.n_shift, cfg.win_length, cfg.fmin,
        cfg.fmax, cfg.n_mels)
    wav, _ = load_wav(wav_path, sr=cfg.fs)
    if wav.ndim != 1 or np.abs(wav).max() > 1.0:
        return ("skipping %s: %s (reference asserts 16-bit PCM range, "
                "GANVocoder/preprocess.py:50-53)"
                % (utt, "not mono" if wav.ndim != 1 else "peak > 1.0"))
    if sent is not None:
        phones, durs = sent
        wav, _, _ = cut_silence(wav, phones, durs, cfg.n_shift)
    mel = mel_extractor.get_log_mel_fbank(wav)
    # num_samples == num_frames * n_shift (reference
    # examples/GANVocoder/preprocess.py:81-87)
    need = mel.shape[0] * cfg.n_shift
    if wav.size < need:
        wav = np.pad(wav, (0, need - wav.size), mode="reflect")
    else:
        wav = wav[:need]
    np.save(dumpdir / f"{utt}_wave.npy", wav.astype(np.float32))
    np.save(dumpdir / f"{utt}_feats.npy", mel.astype(np.float32))
    return {
        "utt_id": utt,
        "num_samples": int(len(wav)),
        "num_frames": int(mel.shape[0]),
        "wave": str(dumpdir / f"{utt}_wave.npy"),
        "feats": str(dumpdir / f"{utt}_feats.npy"),
    }


def main(argv=None) -> list:
    """Preprocess with ``argv`` (default: the command line); returns the
    metadata rows written."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rootdir", type=Path, required=True)
    parser.add_argument("--dumpdir", type=Path, default=Path("dump"))
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--dur-file", type=Path, default=None,
                        help="MFA durations.txt; restricts the corpus to "
                             "aligned utterances and enables --cut-sil")
    parser.add_argument("--cut-sil", action="store_true",
                        help="trim leading/trailing sil (needs --dur-file)")
    parser.add_argument("--dev-size", type=int, default=100)
    parser.add_argument("--num-cpu", type=int, default=1)
    args = parser.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    sentences = None
    if args.dur_file is not None:
        sentences, _ = read_duration_file(args.dur_file)
        merge_silence(sentences)
    elif args.cut_sil:
        parser.error("--cut-sil requires --dur-file")

    args.dumpdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for wav_path in sorted(args.rootdir.glob("*.wav")):
        utt = wav_path.stem
        if utt.endswith("_mic2"):  # vctk naming
            utt = utt[:-5]
        if sentences is not None and utt not in sentences:
            continue
        sent = None
        if args.cut_sil:
            phones, durs, _spk = sentences[utt]
            sent = (phones, durs)
        jobs.append((utt, wav_path, sent))

    results = run_jobs(process_utterance, jobs, args.num_cpu, cfg,
                       args.dumpdir)
    records = []
    for r in results:
        if isinstance(r, str):
            print(r)
        else:
            records.append(r)
    write_jsonl(args.dumpdir / "metadata_dev.jsonl",
                records[:args.dev_size])
    write_jsonl(args.dumpdir / "metadata_train.jsonl",
                records[args.dev_size:])
    print(f"wrote {len(records)} utterances to {args.dumpdir}")
    return records


if __name__ == "__main__":
    main()
