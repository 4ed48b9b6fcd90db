"""Run FastSpeech2 + Parallel WaveGAN from exported programs, in the port
(counterpart of ``recipes/fastspeech2/inference.py``; reference analog:
examples/speedyspeech/baker/inference.py:39-52 loading
``paddle.jit.save``d static graphs).

The deploy path: ``fastspeech2.pt2`` and ``pwgan.pt2``, the
``torch.export`` programs that ``synthesize_e2e.py --export-dir`` writes
(parameters and normalisation statistics baked in), are loaded with
``torch.export.load`` and run without the model code; only the text
frontend runs in Python.  Importing ``recipes/synthesis.py`` registers
K1's operator first, which a program exported on the card holds.  A
program made for another device than ``--device``, or a directory that
holds only JAX's ``.jaxexport`` files, is refused.

Each line of ``--text`` becomes phone ids through the frontend of
``--lang``, cut to the program's text length.  The acoustic program runs
at its exported (1, L) shape, on the card as one CUDA graph captured once
and replayed for every line; the vocoder runs eagerly at its exported
capacity, max_frames x hop samples, on one noise drawn once from a
generator on the device seeded 0 (JAX draws it from ``PRNGKey(0)``; the
streams differ), and the wav is cut to the predicted frames.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of both programs; ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.inference \\
      --export-dir exported/ --phones-dict dump/phone_id_map.txt \\
      --lang zh --text sentences.txt --output-dir wavs [--device cpu]
"""
import argparse
import time
from pathlib import Path

from ...audio.codec import save_wav
from ...frontend.cli import build_text_to_ids
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..synthesis import (ExportedSpeech, Stopwatch, load_exports,
                         read_sentences)

__all__ = ["main"]


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, frames, samples,
    frontend_s, am_s, vocoder_s, path, mel, wav}], "speech": the
    ``ExportedSpeech``}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--export-dir", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--text", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--lang", default="zh",
                        choices=("zh", "en", "en-char"))
    parser.add_argument("--fs", type=int, default=24000)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    clock = Stopwatch(device)
    speech = ExportedSpeech(load_exports(args.export_dir,
                                         ("fastspeech2", "pwgan"), device),
                            ("text", "text_lengths"), device)
    capture_s = clock.seconds()
    get_ids = build_text_to_ids(args.lang, args.phones_dict)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for utt_id, sentence in read_sentences(args.text):
        tic = time.perf_counter()
        ids = get_ids(sentence)[:speech.max_text_len]
        frontend_s = time.perf_counter() - tic
        if not ids:
            print(f"{utt_id}: empty phone sequence, skipping")
            continue
        record = speech(utt_id, ids)
        if record is None:
            continue
        record["frontend_s"] = frontend_s
        out = args.output_dir / f"{utt_id}.wav"
        save_wav(out, record["wav"], args.fs)
        record["path"] = str(out)
        lines.append(record)
    return {"capture_s": capture_s, "sample_rate": args.fs, "lines": lines,
            "speech": speech}


if __name__ == "__main__":
    main()
