"""TransformerTTS batch synthesis from a normalized dump in the port:
phone ids -> mel -> wav (counterpart of
``recipes/transformer_tts/synthesize.py``; reference:
examples/transformer_tts/synthesize.py).

Each row of ``--test-metadata`` (``normalize.py``'s output) gives its
token ids (``text``), cut to ``--max-text-len``.  ``TransformerTTS.
inference`` decodes them at the static shape (1, ``--max-text-len``)
with its KV caches over exactly ``--max-decoder-steps`` steps: on the
card one CUDA graph, captured once and replayed for every row
(``synthesize_e2e.py::decode_program``), the prenet's always-on dropout
masks drawn once from seed 0.  The mel is cut to the decoded frames,
``--stat`` undoes its normalisation, and it is written as ``<utt>.npy``,
or with ``--pwg-*`` vocoded eagerly by Parallel WaveGAN (kernel K1 on the
card) on noise from a generator seeded 0 and written as ``<utt>.wav``.

TF32 is off.  Each row prints its frames and the host-clock times
(synchronised) of the decode and the vocoder; ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.transformer_tts.synthesize \\
      --config recipes/transformer_tts/conf/default.yaml \\
      --checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --stat dump/speech_stats.npy \\
      --test-metadata dump_norm/test/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt \\
      [--pwg-config ... --pwg-checkpoint ...] --output-dir wavs \\
      [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...audio.codec import save_wav
from ...bridge import load_checkpoint_params
from ...data.datatable import read_jsonl
from ...models import TransformerTTS
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..common import count_lines
from ..synthesis import Stopwatch
from .synthesize_e2e import build_vocoder, decode_program

__all__ = ["main", "synthesize_rows"]


def synthesize_rows(rows, program, norm, vocoder, fs, max_text_len: int,
                    output_dir: Path, device) -> list:
    """Decode each metadata row with ``program`` (a ``TextProgram`` that
    returns (mel, lengths)), undo ``norm``, then write the mel as .npy
    (``vocoder`` None) or vocode it and write a wav at ``fs``; returns
    each row's {utt_id, ids, frames, samples, am_s, vocoder_s, path, mel,
    wav}."""
    output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for row in rows:
        ids = row["text"][:max_text_len]
        clock = Stopwatch(device)
        mel, lengths = program(ids)
        n = int(lengths[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"{row['utt_id']}: decoded 0 frames, skipping")
            continue
        mel = mel[0, :n]
        if norm is not None:
            mel = norm.inverse(mel)
        record = {"utt_id": row["utt_id"], "ids": ids, "frames": n,
                  "am_s": am_s, "vocoder_s": None, "samples": None,
                  "wav": None, "mel": mel.float().cpu().numpy()}
        if vocoder is None:
            out = output_dir / f"{row['utt_id']}.npy"
            np.save(out, record["mel"])
        else:
            clock = Stopwatch(device)
            with torch.no_grad():
                wav = vocoder(mel.float()).float().cpu().numpy()
            record["vocoder_s"] = clock.seconds()
            record["wav"], record["samples"] = wav, len(wav)
            out = output_dir / f"{row['utt_id']}.wav"
            save_wav(out, wav, fs)
        record["path"] = str(out)
        lines.append(record)
        print(f"{row['utt_id']}: {n} frames -> {out} (decode "
              f"{1e3 * am_s:.1f} ms" + (
                  "" if record["vocoder_s"] is None else
                  f", vocoder {1e3 * record['vocoder_s']:.1f} ms") + ")")
    return lines


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines", "program"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stat", type=Path, default=None)
    parser.add_argument("--test-metadata", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--pwg-config", type=Path, default=None)
    parser.add_argument("--pwg-checkpoint", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-text-len", type=int, default=192)
    parser.add_argument("--max-decoder-steps", type=int, default=500)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if (args.pwg_config is None) != (args.pwg_checkpoint is None):
        parser.error("--pwg-config and --pwg-checkpoint must be given "
                     "together")
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    model = TransformerTTS(idim=count_lines(args.phones_dict),
                           odim=cfg.n_mels,
                           **inference_model_kwargs(cfg.get("model", {})))
    load_checkpoint_params(model, args.checkpoint)
    model.to(device).eval()
    norm = ZScore(*np.load(args.stat)).to(device) if args.stat else None
    vocoder, fs = build_vocoder(args, device)

    clock = Stopwatch(device)
    program = decode_program(model, args.max_text_len,
                             args.max_decoder_steps, device)
    capture_s = clock.seconds()
    lines = synthesize_rows(read_jsonl(args.test_metadata), program, norm,
                            vocoder, fs, args.max_text_len, args.output_dir,
                            device)
    return {"capture_s": capture_s, "sample_rate": fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
