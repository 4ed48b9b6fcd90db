"""Numerical parity of a converted checkpoint against reference goldens
(counterpart of ``tools/verify_parity.py``: the BASELINE.md acceptance
criterion, mel MSE < 1e-3 on the same inputs).

The golden file is a .npz dumped from the reference implementation on a
machine with Paddle installed:

    # fastspeech2 / speedyspeech (deterministic, non-AR):
    np.savez("golden.npz", text=text_ids, text_lengths=[n],
             mel=model.inference(paddle.to_tensor(text_ids)).numpy())
    # parallel_wavegan: include the exact noise used
    np.savez("golden.npz", mel=mel, noise=noise,
             wav=generator.inference(c=mel, x=noise).numpy())

Exit code 0 iff MSE < threshold; prints one JSON line either way.

Usage:
  python -m parakeet_tpu_torch.tools.verify_parity --model fastspeech2 \\
      --config conf/default.yaml --checkpoint converted.npz \\
      --golden golden.npz [--threshold 1e-3] [--device cpu]
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..bridge import load_checkpoint_params
from ..models import FastSpeech2, PWGGenerator, SpeedySpeech, pwg_inference
from ..training.checkpoint import load_variables
from ..training.config import Config, inference_model_kwargs
from ..utils.device import add_device_arg, disable_tf32, set_device

__all__ = ["main", "RUNNERS"]


def _batched(a) -> np.ndarray:
    a = np.asarray(a)
    return a[None] if a.ndim == 2 else a


def _model(cls, args, device, **kwargs):
    model = cls(**kwargs)
    load_checkpoint_params(model, args.checkpoint)
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def run_fastspeech2(args, golden, device):
    cfg = Config.from_yaml(args.config)
    params = load_variables(args.checkpoint)["params"]
    idim = int(params["encoder"]["embed"]["embedding"].shape[0])
    model = _model(FastSpeech2, args, device, idim=idim, odim=cfg.n_mels,
                   **inference_model_kwargs(cfg.get("model", {})))
    text = torch.as_tensor(np.asarray(golden["text"]), device=device)
    if text.ndim == 1:
        text = text[None]
    ref = _batched(golden["mel"])
    n = ref.shape[1]
    # the reference allows zero-length tokens; flooring would shift frames
    out = model.inference(text, torch.as_tensor(
        np.asarray(golden["text_lengths"]), device=device),
        max_frames=max(n, 8), min_duration=0)
    return out["after_outs"][:, :n].float().cpu().numpy(), ref


@torch.no_grad()
def run_speedyspeech(args, golden, device):
    cfg = Config.from_yaml(args.config)
    params = load_variables(args.checkpoint)["params"]
    vocab = int(params["embedding"]["text_embed"]["embedding"].shape[0])
    model = _model(SpeedySpeech, args, device, vocab_size=vocab,
                   **inference_model_kwargs(cfg.get("model", {})))
    text = torch.as_tensor(np.asarray(golden["text"]), device=device)
    if text.ndim == 1:
        text = text[None]
    tones = golden.get("tones")
    if tones is not None:
        tones = torch.as_tensor(np.asarray(tones), device=device)
        if tones.ndim == 1:
            tones = tones[None]
    ref = _batched(golden["mel"])
    n = ref.shape[1]
    out = model.inference(text, tones, max_frames=max(n, 8))
    return out["mel"][:, :n].float().cpu().numpy(), ref


@torch.no_grad()
def run_pwgan(args, golden, device):
    cfg = Config.from_yaml(args.config)
    gen = _model(PWGGenerator, args, device, **inference_model_kwargs(
        cfg.get("generator_params", {})))
    noise = golden.get("noise")
    if noise is None:
        raise SystemExit(
            "pwgan goldens must include the exact 'noise' array the "
            "reference used: random noise can never match the wav")
    mel = torch.as_tensor(np.asarray(golden["mel"]), dtype=torch.float32,
                          device=device)
    wav = pwg_inference(gen, mel, noise=torch.as_tensor(
        np.asarray(noise), dtype=torch.float32, device=device))
    ref = np.asarray(golden["wav"]).reshape(-1)
    return wav.float().cpu().numpy().reshape(-1)[:len(ref)], ref


RUNNERS = {"fastspeech2": run_fastspeech2,
           "speedyspeech": run_speedyspeech,
           "pwgan": run_pwgan}


def main(argv=None) -> int:
    """Run the check; returns the exit code (0 iff MSE < threshold)."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0], epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True, choices=sorted(RUNNERS))
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--golden", type=Path, required=True)
    parser.add_argument("--threshold", type=float, default=1e-3)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    golden = dict(np.load(args.golden))
    got, ref = RUNNERS[args.model](args, golden, device)
    mse = float(np.mean((got.astype(np.float64)
                         - ref.astype(np.float64)) ** 2))
    ok = mse < args.threshold
    print(json.dumps({"metric": f"{args.model}_golden_mse", "value": mse,
                      "threshold": args.threshold, "pass": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
