"""WaveFlow batch synthesis in the port: mel .npy files -> waveform
(counterpart of ``recipes/waveflow/synthesize.py``; reference:
examples/waveflow/synthesize.py).

Every ``.npy`` in ``--input`` (a (T, n_mels) mel), in name order, is cut
or zero-padded to ``--max-frames`` frames (the JAX CLI's static length)
and sampled by the flow's inverse (``ConditionalWaveFlow.infer``) with
``--sigma`` times standard-normal noise, drawn for each file in turn from
one generator on the device seeded ``--seed`` (the JAX CLI splits a key
seeded the same; the streams differ); ``--sample-dtype bfloat16`` runs the
sampler's activations in bf16.  On the card the sampler at that shape is
one CUDA graph (the sampler graph of ``benchmarks/waveflow_rtf.py``),
captured once and replayed for every file; on the CPU it runs eagerly.
The wav is cut to the file's frames and written as ``<stem>.wav``.

TF32 is off.  Each file prints its frames and the sampler's host-clock
time (synchronised); ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.waveflow.synthesize \\
      --config recipes/waveflow/conf/default.yaml \\
      --checkpoint exp/checkpoints/snapshot_iter_N.npz --input mels/ \\
      --output wavs [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...audio.codec import save_wav
from ...bridge import load_checkpoint_params
from ...models import ConditionalWaveFlow
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ...utils.graphs import CapturedProgram
from ..synthesis import Stopwatch

__all__ = ["main"]


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, frames, samples,
    vocoder_s, path, wav}], "program": the captured sampler or None}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--input", type=Path, required=True,
                        help="directory of mel .npy files (T, n_mels)")
    parser.add_argument("--output", type=Path, default=Path("wavs"))
    parser.add_argument("--max-frames", type=int, default=1024)
    parser.add_argument("--sigma", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sample-dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="the sampler's activation dtype (parameters "
                             "and the affine inversion stay float32)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    model_kwargs = inference_model_kwargs(cfg.get("model", {}))
    model_kwargs["sigma"] = args.sigma
    if args.sample_dtype == "bfloat16":
        model_kwargs["sample_act_dtype"] = torch.bfloat16
    model = ConditionalWaveFlow(**model_kwargs)
    load_checkpoint_params(model, args.checkpoint)
    model.to(device).eval()
    upsample = model.encoder.upsample_factor
    n_mels = model_kwargs.get("n_mels", 80)

    inputs = {"mel": torch.zeros((1, args.max_frames, n_mels),
                                 device=device),
              "noise": torch.zeros((1, model.samples(args.max_frames)),
                                   device=device)}

    def sample(mel, noise):
        return model.infer(mel, noise=noise)

    clock = Stopwatch(device)
    program = (CapturedProgram(sample, inputs) if device.type == "cuda"
               else None)
    capture_s = clock.seconds()
    rng = torch.Generator(device=device).manual_seed(args.seed)

    args.output.mkdir(parents=True, exist_ok=True)
    lines = []
    for path in sorted(args.input.glob("*.npy")):
        mel = np.load(path).astype(np.float32)
        n = min(mel.shape[0], args.max_frames)
        padded = np.zeros((args.max_frames, mel.shape[1]), np.float32)
        padded[:n] = mel[:n]
        clock = Stopwatch(device)
        inputs["mel"].copy_(torch.from_numpy(padded)[None])
        inputs["noise"].normal_(generator=rng)
        if program is None:
            with torch.no_grad():
                wav = sample(**inputs)
        else:
            wav = program()
        wav = wav[0, :n * upsample].float().cpu().numpy()
        vocoder_s = clock.seconds()
        out = args.output / f"{path.stem}.wav"
        save_wav(out, wav, cfg.fs)
        lines.append({"utt_id": path.stem, "frames": n, "samples": len(wav),
                      "vocoder_s": vocoder_s, "path": str(out), "wav": wav})
        print(f"{path.stem}: {n} frames -> {out} (sampler "
              f"{1e3 * vocoder_s:.1f} ms)")
    return {"capture_s": capture_s, "sample_rate": cfg.fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
