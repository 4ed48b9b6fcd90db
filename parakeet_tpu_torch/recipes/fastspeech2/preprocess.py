"""FastSpeech2 preprocessing in the port (counterpart of
``recipes/fastspeech2/preprocess.py``, whose pipeline it copies):
durations + wavs -> mel/pitch/energy + metadata.

Equivalent of the reference recipe (reference:
examples/fastspeech2/preprocess.py:40-220): reads a duration file derived
from MFA TextGrids (``utt|spk|phn dur ...``), extracts log-mel and
token-averaged pitch/energy per utterance (pitch by YIN where pyworld is
missing, ``audio/features.py::Pitch``), writes ``.npy`` features,
``metadata_{dev,test,train}.jsonl`` splits in utt_id order, and the
phone/speaker id maps.  ``--num-cpu N`` processes utterances in N worker
processes.  Host code; nothing runs on the card.

A YAML without ``f0min``/``f0max`` (Tacotron2's and TransformerTTS's,
whose ``run.sh`` runs this stage) takes FastSpeech2's 80 and 400 Hz,
where the JAX CLI raises on the missing keys: those models read no
pitch.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.preprocess \\
      --rootdir wavs/ --duration-file durations.txt --dumpdir dump \\
      --config recipes/fastspeech2/conf/default.yaml [--num-cpu 8]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import cached_extractors
from ...data.preprocess import (build_phone_id_map, build_spk_id_map,
                                merge_silence, read_duration_file,
                                reconcile_durations)
from ...training import Config
from ..common import add_split_args, run_jobs, write_splits

__all__ = ["main", "process_utterance", "F0_RANGE"]

F0_RANGE = (80, 400)        # recipes/fastspeech2/conf/*.yaml's f0min, f0max


def process_utterance(utt, wav_path, phones, durations, speaker, cfg,
                      dumpdir):
    """One utterance's mel, pitch and energy files and its metadata row,
    or None when its durations cannot be reconciled with its frames."""
    wav, _ = load_wav(wav_path, sr=cfg.fs)
    mel_extractor, pitch_extractor, energy_extractor = cached_extractors(
        cfg.fs, cfg.n_fft, cfg.n_shift, cfg.win_length, cfg.fmin,
        cfg.fmax, cfg.n_mels, cfg.get("f0min", F0_RANGE[0]),
        cfg.get("f0max", F0_RANGE[1]))
    mel = mel_extractor.get_log_mel_fbank(wav)          # (T, n_mels)
    sent = {utt: [phones, list(durations), speaker]}
    if not reconcile_durations(sent, utt, mel.shape[0]):
        return None
    durations = np.asarray(sent[utt][1], dtype=np.int64)
    pitch = pitch_extractor.get_pitch(wav, duration=durations)
    energy = energy_extractor.get_energy(wav, duration=durations)

    out = Path(dumpdir)
    np.save(out / f"{utt}_speech.npy", mel.astype(np.float32))
    np.save(out / f"{utt}_pitch.npy",
            np.asarray(pitch, np.float32).reshape(-1, 1))
    np.save(out / f"{utt}_energy.npy",
            np.asarray(energy, np.float32).reshape(-1, 1))
    return {
        "utt_id": utt,
        "phones": phones,
        "text_lengths": len(phones),
        "speech_lengths": int(mel.shape[0]),
        "durations": [int(d) for d in durations],
        "speech": str(out / f"{utt}_speech.npy"),
        "pitch": str(out / f"{utt}_pitch.npy"),
        "energy": str(out / f"{utt}_energy.npy"),
        "speaker": speaker,
    }


def main(argv=None) -> list:
    """Preprocess with ``argv`` (default: the command line); returns the
    metadata rows written, in utt_id order."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rootdir", type=Path, required=True,
                        help="directory containing <utt_id>.wav files")
    parser.add_argument("--duration-file", type=Path, required=True)
    parser.add_argument("--dumpdir", type=Path, default=Path("dump"))
    parser.add_argument("--config", type=Path, required=True)
    add_split_args(parser)
    args = parser.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    sentences, speakers = read_duration_file(args.duration_file)
    merge_silence(sentences)

    args.dumpdir.mkdir(parents=True, exist_ok=True)
    build_phone_id_map(sentences, args.dumpdir / "phone_id_map.txt")
    build_spk_id_map(sorted(speakers), args.dumpdir / "speaker_id_map.txt")

    jobs = []
    for utt, (phones, durations, speaker) in sentences.items():
        wav_path = args.rootdir / f"{utt}.wav"
        if not wav_path.exists():
            print(f"skip {utt}: no wav", file=sys.stderr)
            continue
        jobs.append((utt, wav_path, phones, durations, speaker))

    records = run_jobs(process_utterance, jobs, args.num_cpu, cfg,
                       args.dumpdir)
    records = [r for r in records if r is not None]
    records.sort(key=lambda r: r["utt_id"])
    write_splits(args.dumpdir, records, args.dev_size, args.test_size)
    return records


if __name__ == "__main__":
    main()
