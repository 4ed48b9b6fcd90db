"""Run SpeedySpeech + Parallel WaveGAN from exported programs, in the port
(counterpart of ``recipes/speedyspeech/inference.py``; reference:
examples/speedyspeech/baker/inference.py:39-52, which loads the
``paddle.jit.save``d static graphs through paddle.inference).

``speedyspeech.pt2`` and ``pwgan.pt2``, the ``torch.export`` programs
that ``synthesize_e2e.py --export-dir`` writes (parameters and the mel
statistics baked in), are loaded with ``torch.export.load`` and run
without the model code; only the Chinese frontend
(``frontend/zh_frontend.py::Frontend``, ``--phones-dict`` and
``--tones-dict``) runs in Python.  Importing ``recipes/synthesis.py``
registers K1's operator first, which a program exported on the card
holds.  A program made for another device than ``--device``, or a
directory that holds only JAX's ``.jaxexport`` files, is refused.

The ids and tones (zeros without tones) run through the acoustic program
at its exported (1, L) shape, on the card as one CUDA graph captured once
and replayed for every line; the vocoder runs eagerly at its exported
capacity on one noise drawn once from a generator on the device seeded 0
(the JAX CLI's key gives other numbers), and the wav is cut to the
predicted frames.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of both programs; ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.speedyspeech.inference \\
      --export-dir exported/ --phones-dict dump/phone_id_map.txt \\
      --tones-dict dump/tone_id_map.txt --text sentences.txt \\
      --output-dir wavs [--device cpu]
"""
import argparse
import time
from pathlib import Path

from ...audio.codec import save_wav
from ...frontend.zh_frontend import Frontend
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..synthesis import (ExportedSpeech, Stopwatch, load_exports,
                         read_sentences)

__all__ = ["main"]


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, tones, frames,
    samples, frontend_s, am_s, vocoder_s, path, mel, wav}], "speech"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--export-dir", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--tones-dict", type=Path, default=None)
    parser.add_argument("--text", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--fs", type=int, default=24000)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    clock = Stopwatch(device)
    speech = ExportedSpeech(load_exports(args.export_dir,
                                         ("speedyspeech", "pwgan"), device),
                            ("text", "tones"), device)
    capture_s = clock.seconds()
    frontend = Frontend(phone_vocab_path=args.phones_dict,
                        tone_vocab_path=args.tones_dict)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for utt_id, sentence in read_sentences(args.text):
        tic = time.perf_counter()
        ids = frontend.get_input_ids(sentence)
        frontend_s = time.perf_counter() - tic
        phone_ids = ids["phone_ids"][0][:speech.max_text_len]
        tone_ids = (ids["tone_ids"][0][:speech.max_text_len]
                    if "tone_ids" in ids else None)
        record = speech(utt_id, phone_ids, tone_ids)
        if record is None:
            continue
        record.update(frontend_s=frontend_s, tones=tone_ids)
        out = args.output_dir / f"{utt_id}.wav"
        save_wav(out, record["wav"], args.fs)
        record["path"] = str(out)
        lines.append(record)
    return {"capture_s": capture_s, "sample_rate": args.fs, "lines": lines,
            "speech": speech}


if __name__ == "__main__":
    main()
