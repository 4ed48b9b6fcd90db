"""SpeedySpeech preprocessing in the port (counterpart of
``recipes/speedyspeech/preprocess.py``, whose pipeline it copies):
durations + wavs -> mel + phones/tones.

Equivalent of the reference recipe (reference:
examples/speedyspeech/baker/preprocess.py): reads an MFA-derived
duration file, splits tone digits off the pinyin finals (``ang4`` ->
``ang`` + ``4``), extracts log-mel, writes ``.npy`` features,
``metadata_{dev,test,train}.jsonl`` (phone and tone ids already numeric)
and the phone/tone id maps.  ``--num-cpu N`` processes utterances in N
worker processes.  Host code; nothing runs on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.speedyspeech.preprocess \\
      --rootdir wavs/ --duration-file durations.txt --dumpdir dump \\
      --config recipes/speedyspeech/conf/default.yaml [--num-cpu 8]
"""
import argparse
import functools
import re
import sys
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import LogMelFBank
from ...data.preprocess import (build_phone_tone_id_maps, merge_silence,
                                read_duration_file, reconcile_durations)
from ...training import Config
from ..common import add_split_args, run_jobs, write_splits

__all__ = ["main", "process_utterance", "split_phone_tone"]

_TONED = re.compile(r"^(\w+)([012345])$")


def split_phone_tone(label: str):
    """(base, tone digit) of a toned label, (label, "0") otherwise."""
    m = _TONED.match(label)
    if m:
        return m.group(1), m.group(2)
    return label, "0"


@functools.lru_cache(maxsize=4)
def _mel_extractor(fs, n_fft, n_shift, win_length, fmin, fmax, n_mels):
    return LogMelFBank(sr=fs, n_fft=n_fft, hop_length=n_shift,
                       win_length=win_length, fmin=fmin, fmax=fmax,
                       n_mels=n_mels)


def process_utterance(utt, wav_path, phones, durations, cfg, dumpdir,
                      phone_ids, tone_ids):
    """One utterance's mel file and its metadata row, or None when its
    durations cannot be reconciled with its frames."""
    wav, _ = load_wav(wav_path, sr=cfg.fs)
    mel_extractor = _mel_extractor(cfg.fs, cfg.n_fft, cfg.n_shift,
                                   cfg.win_length, cfg.fmin, cfg.fmax,
                                   cfg.n_mels)
    mel = mel_extractor.get_log_mel_fbank(wav)
    sent = {utt: [phones, list(durations), "baker"]}
    if not reconcile_durations(sent, utt, mel.shape[0]):
        return None
    durations = [int(d) for d in sent[utt][1]]

    bases, tones = [], []
    for label in phones:
        base, tone = split_phone_tone(label)
        bases.append(phone_ids.get(base, phone_ids.get("<unk>", 1)))
        tones.append(tone_ids.get(tone, 0))

    out = Path(dumpdir)
    np.save(out / f"{utt}_feats.npy", mel.astype(np.float32))
    return {
        "utt_id": utt,
        "phones": bases,
        "tones": tones,
        "num_phones": len(bases),
        "num_frames": int(mel.shape[0]),
        "durations": durations,
        "feats": str(out / f"{utt}_feats.npy"),
    }


def main(argv=None) -> list:
    """Preprocess with ``argv`` (default: the command line); returns the
    metadata rows written, in utt_id order."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rootdir", type=Path, required=True)
    parser.add_argument("--duration-file", type=Path, required=True)
    parser.add_argument("--dumpdir", type=Path, default=Path("dump"))
    parser.add_argument("--config", type=Path, required=True)
    add_split_args(parser)
    args = parser.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    sentences, _speakers = read_duration_file(args.duration_file)
    merge_silence(sentences)

    args.dumpdir.mkdir(parents=True, exist_ok=True)
    phone_table, tone_table = build_phone_tone_id_maps(
        sentences, args.dumpdir / "phone_id_map.txt",
        args.dumpdir / "tone_id_map.txt")
    phone_ids = {p: i for i, p in enumerate(phone_table)}
    tone_ids = {t: i for i, t in enumerate(tone_table)}

    jobs = []
    for utt, (phones, durations, _spk) in sentences.items():
        wav_path = args.rootdir / f"{utt}.wav"
        if not wav_path.exists():
            print(f"skip {utt}: no wav", file=sys.stderr)
            continue
        jobs.append((utt, wav_path, phones, durations))

    records = run_jobs(process_utterance, jobs, args.num_cpu, cfg,
                       args.dumpdir, phone_ids, tone_ids)
    records = [r for r in records if r is not None]
    records.sort(key=lambda r: r["utt_id"])
    write_splits(args.dumpdir, records, args.dev_size, args.test_size)
    return records


if __name__ == "__main__":
    main()
