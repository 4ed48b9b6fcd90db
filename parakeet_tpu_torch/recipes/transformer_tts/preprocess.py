"""TransformerTTS preprocessing in the port (counterpart of
``recipes/transformer_tts/preprocess.py``, whose pipeline it copies):
LJSpeech -> (phones, log-mel) + metadata.

Equivalent of the reference AR-model preprocessing (reference:
examples/transformer_tts/preprocess.py:33-260): phoneticize the
normalized text of ``metadata.csv`` with the English frontend
(``--frontend phone``, ARPABET through g2p_en) or as characters
(``--frontend char``, the Tacotron2 recipe's default), extract
per-utterance log-mel, build the phone id map (<pad>/<unk> + sorted phone
set + <eos>), and split dev/test/train in the csv's order.  No durations:
the model aligns by attention.  ``--num-cpu N`` processes utterances in N
worker processes.  Host code; nothing runs on the card.

Usage:
  python -m parakeet_tpu_torch.recipes.transformer_tts.preprocess \\
      --rootdir ~/datasets/LJSpeech-1.1 --dumpdir dump \\
      --config recipes/transformer_tts/conf/default.yaml \\
      [--dev-size 100 --test-size 100] [--num-cpu 8]
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav
from ...audio.features import cached_extractors
from ...data.datasets import LJSpeechMetaData
from ...frontend import English, EnglishCharacter
from ...training import Config
from ..common import add_split_args, run_jobs, write_splits

__all__ = ["main", "process_utterance", "build_phone_id_map"]


def build_phone_id_map(sentences, output_path):
    """<pad>/<unk> + sorted phone set + <eos> (reference
    preprocess.py:61-83)."""
    phones = sorted({p for phns, _ in sentences.values() for p in phns})
    tokens = ["<pad>", "<unk>"] + phones + ["<eos>"]
    with open(output_path, "w") as f:
        for i, p in enumerate(tokens):
            f.write(f"{p} {i}\n")
    return {p: i for i, p in enumerate(tokens)}


def process_utterance(utt, wav_path, phones, speaker, cfg, dumpdir):
    """One utterance's log-mel file and its metadata row."""
    mel_extractor, _, _ = cached_extractors(
        cfg.fs, cfg.n_fft, cfg.n_shift, cfg.win_length, cfg.fmin,
        cfg.fmax, cfg.n_mels)
    wav, _ = load_wav(wav_path, sr=cfg.fs)
    mel = mel_extractor.get_log_mel_fbank(wav)
    np.save(dumpdir / f"{utt}_speech.npy", mel.astype(np.float32))
    return {
        "utt_id": utt,
        "phones": phones,
        "text_lengths": len(phones),
        "speech_lengths": int(mel.shape[0]),
        "speech": str(dumpdir / f"{utt}_speech.npy"),
        "speaker": speaker,
    }


def main(argv=None) -> list:
    """Preprocess with ``argv`` (default: the command line); returns the
    metadata rows written."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rootdir", type=Path, required=True,
                        help="LJSpeech-1.1 root (metadata.csv + wavs/)")
    parser.add_argument("--dumpdir", type=Path, default=Path("dump"))
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--frontend", default="phone",
                        choices=("phone", "char"),
                        help="ARPABET phones (TransformerTTS) or raw "
                             "characters (the Tacotron2 convention, "
                             "reference examples/tacotron2/preprocess.py)")
    add_split_args(parser)
    args = parser.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    text_frontend = (English() if args.frontend == "phone"
                     else EnglishCharacter())
    meta = LJSpeechMetaData(args.rootdir)
    sentences = {}
    wav_paths = {}
    for wav_path, normalized, _raw in meta.records:
        utt = Path(wav_path).stem
        phones = text_frontend.phoneticize(normalized)
        if args.frontend == "phone":
            # ARPABET emits word-separator spaces; drop them
            phones = [p for p in phones if not p.isspace()]
        else:
            # characters keep word boundaries (the reference character
            # vocab includes " "), encoded map-safely as <sp>
            phones = ["<sp>" if p.isspace() else p for p in phones]
        if not phones:
            continue
        sentences[utt] = (phones, utt[:2])  # speaker = LJ prefix
        wav_paths[utt] = wav_path

    args.dumpdir.mkdir(parents=True, exist_ok=True)
    build_phone_id_map(sentences, args.dumpdir / "phone_id_map.txt")

    jobs = [(utt, wav_paths[utt], phones, speaker)
            for utt, (phones, speaker) in sentences.items()]
    records = run_jobs(process_utterance, jobs, args.num_cpu, cfg,
                       args.dumpdir)
    write_splits(args.dumpdir, records, args.dev_size, args.test_size)
    return records


if __name__ == "__main__":
    main()
