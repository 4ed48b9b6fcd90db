"""End-to-end TransformerTTS synthesis in the port: text -> mel -> wav
(counterpart of ``recipes/transformer_tts/synthesize_e2e.py``; reference:
examples/transformer_tts/ljspeech/synthesize_e2e.py).

1. Each line of ``--text`` (``<utt_id> <sentence>``) becomes phone ids
   through the English frontend (``--lang en``; or ``zh``, ``en-char``)
   and ``--phones-dict``, cut to ``--max-text-len``.
2. ``TransformerTTS.inference`` reads them zero-padded at the static shape
   (1, ``--max-text-len``) and decodes with its KV caches over exactly
   ``--max-decoder-steps`` steps: on the card the whole program (encoder,
   loop, Postnet) is one CUDA graph, captured once and replayed for every
   line, as the JAX CLI jits it once.  The decoder prenet's always-on
   dropout masks are drawn once, from seed 0, before the loop, as the JAX
   CLI's fixed key gives every line the same masks (the streams differ).
   The mel is cut to the decoded frames and ``--stat`` undoes its
   normalisation.
3. With ``--pwg-checkpoint`` Parallel WaveGAN (kernel K1 on the card with
   the YAML's ``stack_impl: pallas``), or with ``--waveflow-checkpoint``
   WaveFlow, vocodes the frames eagerly, its noise from a generator seeded
   0 for every line; without a vocoder the mel is written as ``.npy``.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of the decode and the vocoder; ``main`` returns them with
the frontend's.

Usage:
  python -m parakeet_tpu_torch.recipes.transformer_tts.synthesize_e2e \\
      --config recipes/transformer_tts/conf/default.yaml \\
      --checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --stat dump/speech_stats.npy --phones-dict dump/phone_id_map.txt \\
      --waveflow-config recipes/waveflow/conf/default.yaml \\
      --waveflow-checkpoint exp/waveflow/checkpoints/snapshot_iter_M.npz \\
      --text sentences.txt --output-dir wavs [--device cpu]
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ...audio.codec import save_wav
from ...bridge import load_checkpoint_params
from ...frontend.cli import build_text_to_ids
from ...models import ConditionalWaveFlow, TransformerTTS, pwg_inference
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..common import count_lines
from ..fastspeech2.synthesize_e2e import build_vocoder as build_pwg
from ..synthesis import Stopwatch, TextProgram, read_sentences

__all__ = ["main", "build_vocoder"]

# the prenet's masks and the vocoders' noise: one seed for every line
MASK_SEED, NOISE_SEED = 0, 0


def build_vocoder(args, device):
    """(fn mel (T, n_mels) on ``device`` -> wav (T * hop,), sample rate) of
    the vocoder flags, or (None, None)."""
    if args.pwg_checkpoint is not None:
        voc = build_pwg(args.pwg_config, args.pwg_checkpoint, device)

        def run(mel):
            return pwg_inference(voc, mel, rng=torch.Generator(
                device=device).manual_seed(NOISE_SEED))
        return run, Config.from_yaml(args.pwg_config).fs
    if args.waveflow_checkpoint is not None:
        cfg = Config.from_yaml(args.waveflow_config)
        voc = ConditionalWaveFlow(**inference_model_kwargs(
            cfg.get("model", {})))
        load_checkpoint_params(voc, args.waveflow_checkpoint)
        voc.to(device).eval()
        upsample = voc.encoder.upsample_factor

        def run(mel):
            wav = voc.infer(mel[None], torch.Generator(
                device=device).manual_seed(NOISE_SEED))
            return wav[0, :mel.shape[0] * upsample]
        return run, cfg.fs
    return None, None


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, frames, samples,
    frontend_s, am_s, vocoder_s, path, mel, wav}], "program"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stat", type=Path, default=None,
                        help="speech_stats.npy (mean/std) for denorm")
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--text", type=Path, required=True,
                        help="lines: <utt_id> <sentence>")
    parser.add_argument("--waveflow-config", type=Path, default=None)
    parser.add_argument("--waveflow-checkpoint", type=Path, default=None)
    parser.add_argument("--pwg-config", type=Path, default=None)
    parser.add_argument("--pwg-checkpoint", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--lang", default="en",
                        choices=("zh", "en", "en-char"))
    parser.add_argument("--max-text-len", type=int, default=192)
    parser.add_argument("--max-decoder-steps", type=int, default=500)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    for cfg_arg, ckpt_arg, name in (
            (args.pwg_config, args.pwg_checkpoint, "pwg"),
            (args.waveflow_config, args.waveflow_checkpoint, "waveflow")):
        if (cfg_arg is None) != (ckpt_arg is None):
            parser.error(f"--{name}-config and --{name}-checkpoint "
                         "must be given together")
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    model = TransformerTTS(idim=count_lines(args.phones_dict),
                           odim=cfg.n_mels,
                           **inference_model_kwargs(cfg.get("model", {})))
    load_checkpoint_params(model, args.checkpoint)
    model.to(device).eval()
    norm = ZScore(*np.load(args.stat)).to(device) if args.stat else None
    get_ids = build_text_to_ids(args.lang, args.phones_dict)
    vocoder, fs = build_vocoder(args, device)

    steps = args.max_decoder_steps
    inputs = {"text": torch.zeros((1, args.max_text_len), dtype=torch.int64,
                                  device=device),
              "text_lengths": torch.zeros((1,), dtype=torch.int64,
                                          device=device)}
    keep = model.prenet_masks(1, steps,
                              torch.Generator().manual_seed(MASK_SEED), "cpu")
    if keep is not None:
        inputs["prenet_keep"] = keep.to(device)

    def infer(text, text_lengths, prenet_keep=None):
        out = model.inference(text, text_lengths, max_decoder_steps=steps,
                              prenet_keep=prenet_keep)
        return out["mel"], out["lengths"]

    clock = Stopwatch(device)
    program = TextProgram(infer, inputs, graph=device.type == "cuda")
    capture_s = clock.seconds()

    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for utt_id, sentence in read_sentences(args.text):
        tic = time.perf_counter()
        ids = get_ids(sentence)[:args.max_text_len]
        frontend_s = time.perf_counter() - tic
        if not ids:
            print(f"{utt_id}: no phones, skipping")
            continue
        clock = Stopwatch(device)
        mel, lengths = program(ids)
        n = int(lengths[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"{utt_id}: decoded 0 frames, skipping")
            continue
        mel = mel[0, :n]
        if norm is not None:
            mel = norm.inverse(mel)
        record = {"utt_id": utt_id, "ids": ids, "frames": n,
                  "frontend_s": frontend_s, "am_s": am_s, "vocoder_s": None,
                  "samples": None, "wav": None,
                  "mel": mel.float().cpu().numpy()}
        if vocoder is None:
            out = args.output_dir / f"{utt_id}.npy"
            np.save(out, record["mel"])
        else:
            clock = Stopwatch(device)
            with torch.no_grad():
                wav = vocoder(mel.float()).float().cpu().numpy()
            record["vocoder_s"] = clock.seconds()
            record["wav"], record["samples"] = wav, len(wav)
            out = args.output_dir / f"{utt_id}.wav"
            save_wav(out, wav, fs)
        record["path"] = str(out)
        lines.append(record)
        print(f"{utt_id}: {n} frames -> {out} (decode {1e3 * am_s:.1f} ms"
              + ("" if record["vocoder_s"] is None else
                 f", vocoder {1e3 * record['vocoder_s']:.1f} ms") + ")")
    return {"capture_s": capture_s, "sample_rate": fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
