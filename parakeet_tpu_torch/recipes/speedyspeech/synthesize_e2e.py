"""SpeedySpeech end-to-end synthesis in the port: text -> Chinese frontend
-> mel -> Parallel WaveGAN -> wav (counterpart of
``recipes/speedyspeech/synthesize_e2e.py``; reference:
examples/speedyspeech/baker/synthesize_e2e.py:32-101).

1. Each line of ``--text`` (``<utt_id> <sentence>``) goes through the
   Chinese frontend (``frontend/zh_frontend.py::Frontend`` with
   ``--phones-dict`` and, with ``--tones-dict``, the tones), cut to
   ``--max-text-len``.
2. ``SpeedySpeech.inference`` reads the ids (and tones) zero-padded at the
   static shape (1, ``--max-text-len``) to ``--max-frames`` frames, and
   ``--stat`` undoes the mel's normalisation inside the program: on the
   card one CUDA graph, captured once and replayed for every line, as the
   JAX CLI jits it once.
3. The Parallel WaveGAN generator (kernel K1 on the card with the YAML's
   ``stack_impl: pallas``) vocodes the whole ``--max-frames`` mel, as the
   JAX CLI does, with the same noise for every line (a generator seeded 0,
   the JAX CLI's key; the streams differ), and the wav is cut to the
   predicted frames.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of the acoustic model and the vocoder; ``main`` returns
them with the frontend's.  Not ported: ``--export-dir`` (ROADMAP queue 1,
item 17), refused.

Usage:
  python -m parakeet_tpu_torch.recipes.speedyspeech.synthesize_e2e \\
      --config recipes/speedyspeech/conf/default.yaml \\
      --checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --pwg-config recipes/pwgan/conf/default.yaml \\
      --pwg-checkpoint exp/pwg/checkpoints/snapshot_iter_M.npz \\
      --phones-dict dump/phone_id_map.txt --tones-dict dump/tone_id_map.txt \\
      --text sentences.txt --output-dir wavs [--device cpu]
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ...audio.codec import save_wav
from ...bridge import load_checkpoint_params
from ...frontend.zh_frontend import Frontend
from ...models import SpeedySpeech, pwg_inference
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..common import count_lines
from ..fastspeech2.synthesize_e2e import build_vocoder
from ..synthesis import (Stopwatch, TextProgram, add_unported_args,
                         read_sentences, refuse_unported)

__all__ = ["main"]

NOISE_SEED = 0          # the vocoder's noise: one seed for every line


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, tones, frames,
    samples, frontend_s, am_s, vocoder_s, path, mel, wav}], "program"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stat", type=Path, default=None)
    parser.add_argument("--pwg-config", type=Path, required=True)
    parser.add_argument("--pwg-checkpoint", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--tones-dict", type=Path, default=None)
    parser.add_argument("--text", type=Path, required=True,
                        help="lines: <utt_id> <sentence>")
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-text-len", type=int, default=128)
    parser.add_argument("--max-frames", type=int, default=1024)
    add_unported_args(parser, sp=False)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    refuse_unported(args)
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    fs = Config.from_yaml(args.pwg_config).fs
    tone_size = count_lines(args.tones_dict) if args.tones_dict else None
    am = SpeedySpeech(vocab_size=count_lines(args.phones_dict),
                      tone_size=tone_size,
                      **inference_model_kwargs(cfg.get("model", {})))
    load_checkpoint_params(am, args.checkpoint)
    am.to(device).eval()
    voc = build_vocoder(args.pwg_config, args.pwg_checkpoint, device)
    norm = ZScore(*np.load(args.stat)).to(device) if args.stat else None
    frontend = Frontend(phone_vocab_path=args.phones_dict,
                        tone_vocab_path=args.tones_dict)

    def infer(text, tones=None):
        out = am.inference(text, tones, max_frames=args.max_frames)
        mel = out["mel"]
        if norm is not None:
            mel = norm.inverse(mel)
        return mel, out["frame_lengths"]

    def buffer():
        return torch.zeros((1, args.max_text_len), dtype=torch.int64,
                           device=device)

    inputs = {"text": buffer()}
    if args.tones_dict is not None:
        inputs["tones"] = buffer()
    clock = Stopwatch(device)
    program = TextProgram(infer, inputs, graph=device.type == "cuda")
    capture_s = clock.seconds()
    hop = voc.upsample_factor
    noise = torch.randn((1, args.max_frames * hop, 1), generator=torch.
                        Generator(device=device).manual_seed(NOISE_SEED),
                        device=device)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for utt_id, sentence in read_sentences(args.text):
        tic = time.perf_counter()
        ids = frontend.get_input_ids(sentence)
        frontend_s = time.perf_counter() - tic
        phone_ids = ids["phone_ids"][0][:args.max_text_len]
        tone_ids = (ids["tone_ids"][0][:args.max_text_len]
                    if "tone_ids" in ids else None)
        clock = Stopwatch(device)
        mel, frames = program(phone_ids, tone_ids)
        n = int(frames[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"{utt_id}: predicted 0 frames, skipping")
            continue
        clock = Stopwatch(device)
        with torch.no_grad():
            wav = pwg_inference(voc, mel, noise=noise)[0, :n * hop]
        wav = wav.float().cpu().numpy()
        vocoder_s = clock.seconds()
        out = args.output_dir / f"{utt_id}.wav"
        save_wav(out, wav, fs)
        lines.append({"utt_id": utt_id, "ids": phone_ids, "tones": tone_ids,
                      "frames": n, "samples": len(wav),
                      "frontend_s": frontend_s, "am_s": am_s,
                      "vocoder_s": vocoder_s, "path": str(out),
                      "mel": mel[0, :n].float().cpu().numpy(), "wav": wav})
        print(f"{utt_id}: {n} frames -> {out} (AM {1e3 * am_s:.1f} ms, "
              f"vocoder {1e3 * vocoder_s:.1f} ms)")
    return {"capture_s": capture_s, "sample_rate": fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
