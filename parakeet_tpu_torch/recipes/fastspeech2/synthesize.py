"""Batch synthesis from a normalized dump in the port: phone ids -> mel ->
wav (counterpart of ``recipes/fastspeech2/synthesize.py``; reference:
examples/fastspeech2/synthesize.py).

1. Each row of ``--test-metadata`` (``normalize.py``'s output) gives its
   phone ids (``text``), cut to ``--max-text-len``, and with
   ``--speaker-dict`` its speaker (``spk_id``).
2. ``FastSpeech2.inference`` reads them zero-padded at the static shape
   (1, ``--max-text-len``) with ``--max-frames`` of decoder capacity and
   each token's duration floored at 1: on the card one CUDA graph,
   captured once and replayed for every row, as the JAX CLI jits it once.
   The mel is cut to the predicted frames and ``--fastspeech2-stat``
   undoes its normalisation.
3. The Parallel WaveGAN generator (kernel K1 on the card with the YAML's
   ``stack_impl: pallas``) vocodes the frames eagerly, its noise from a
   generator seeded 0 for every row, as the JAX CLI's fixed key (the
   streams differ).

TF32 is off.  Each row prints its frames and the host-clock times
(synchronised) of the acoustic model and the vocoder; ``main`` returns
them.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.synthesize \\
      --fastspeech2-config recipes/fastspeech2/conf/default.yaml \\
      --fastspeech2-checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --fastspeech2-stat dump/speech_stats.npy \\
      --pwg-config recipes/pwgan/conf/default.yaml \\
      --pwg-checkpoint exp/pwg/checkpoints/snapshot_iter_M.npz \\
      --test-metadata dump_norm/test/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt --output-dir wavs [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np

from ...audio.codec import save_wav
from ...data.datatable import read_jsonl
from ...ops.normalizer import ZScore
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..synthesis import Stopwatch
from .synthesize_e2e import (acoustic_program, build_acoustic_model,
                             build_vocoder, vocode)

__all__ = ["main"]

NOISE_SEED = 0          # the vocoder's noise: one seed for every row


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, frames, samples,
    am_s, vocoder_s, path, mel, wav}], "program"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fastspeech2-config", type=Path, required=True)
    parser.add_argument("--fastspeech2-checkpoint", type=Path, required=True)
    parser.add_argument("--fastspeech2-stat", type=Path, default=None)
    parser.add_argument("--pwg-config", type=Path, required=True)
    parser.add_argument("--pwg-checkpoint", type=Path, required=True)
    parser.add_argument("--test-metadata", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--speaker-dict", type=Path, default=None,
                        help="speaker_id_map.txt for multi-speaker models"
                             " (aishell3/vctk)")
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-text-len", type=int, default=192)
    parser.add_argument("--max-frames", type=int, default=1024)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    am, am_cfg = build_acoustic_model(
        args.fastspeech2_config, args.fastspeech2_checkpoint,
        args.phones_dict, args.speaker_dict, device)
    voc = build_vocoder(args.pwg_config, args.pwg_checkpoint, device)
    am_norm = (ZScore(*np.load(args.fastspeech2_stat)).to(device)
               if args.fastspeech2_stat else None)

    clock = Stopwatch(device)
    program = acoustic_program(am, args.max_text_len, args.max_frames, 1,
                               device, None if args.speaker_dict is None
                               else 0)
    capture_s = clock.seconds()
    spk_id = program.inputs.get("spk_id")

    fs = am_cfg.fs
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for row in read_jsonl(args.test_metadata):
        ids = row["text"][:args.max_text_len]
        if spk_id is not None:
            spk_id.fill_(int(row["spk_id"]))
        clock = Stopwatch(device)
        mel, frames = program(ids)
        n = int(frames[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"skip {row['utt_id']}: the model predicted 0 frames")
            continue
        mel = mel[0, :n]
        if am_norm is not None:
            mel = am_norm.inverse(mel)
        clock = Stopwatch(device)
        wav = vocode(voc, mel, NOISE_SEED).float().cpu().numpy()
        vocoder_s = clock.seconds()
        out = args.output_dir / f"{row['utt_id']}.wav"
        save_wav(out, wav, fs)
        lines.append({"utt_id": row["utt_id"], "ids": ids, "frames": n,
                      "samples": len(wav), "am_s": am_s,
                      "vocoder_s": vocoder_s, "path": str(out),
                      "mel": mel.float().cpu().numpy(), "wav": wav})
        print(f"{row['utt_id']}: {n} frames -> {out} (AM {1e3 * am_s:.1f} "
              f"ms, vocoder {1e3 * vocoder_s:.1f} ms)")
    return {"capture_s": capture_s, "sample_rate": fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
