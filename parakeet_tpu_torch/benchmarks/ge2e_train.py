"""GE2E speaker-encoder training throughput of the port (counterpart of
``benchmarks/ge2e_train.py``; reference: examples/ge2e/train.py:48, one
optimizer step per N x M batch).

N training steps of the 3 x 256 LSTM encoder (``models/
lstm_speaker_encoder.py``, flax's initializers from seed 0) through the
port's updater (GE2E loss, the (w, b) gradients x0.01, Adam 1e-4) on one
synthetic (speakers x utterances, frames, n_mels) batch, standard normal
from numpy seed 0 as in the JAX bench, float32 or with ``--dtype
bfloat16`` flax's mixed precision (``nn/precision.py``: float32 weights
cast to bf16 for each cuDNN call, the scale (w, b) bf16 parameters as in
the JAX module).  One step and 3 warm-up
steps run first; then ``--iters`` chained steps are timed from the host,
with one synchronisation at the end.  Prints one JSON line:
``ge2e_train_avg_ips`` in utterances a second (the reference's effective
sample rate), the ms a step, the step's FLOPs (``utils/flops.py::
ge2e_train_flops``: ~0.83 TFLOP at the defaults, forward and backward),
the achieved rate and its share of the card's bf16 peak
(``mfu_stats``), the backend, the card's name and power limit, and
whether cuDNN may use TF32 (``tf32``).  Each layer runs as one
``torch.lstm`` call over all frames: on the card cuDNN's LSTM, which
``main`` keeps in float32 by turning cuDNN's TF32 off (PyTorch's default
turns it on).

Usage:
  python -m parakeet_tpu_torch.benchmarks.ge2e_train [--iters 20] \\
      [--speakers 64] [--utts 10] [--frames 160] \\
      [--dtype float32|bfloat16] [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from ..models import (LSTMSpeakerEncoder, init_ge2e_train_state,
                      make_ge2e_train_step)
from ..nn.initializer import init_flax_defaults_
from ..training import build_optimizer, resolve_model_kwargs
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from ..utils.flops import ge2e_train_flops, mfu_stats
from .common import card

__all__ = ["main", "run", "build_train_step", "MODEL_CONFIG", "WARM_STEPS"]

# the encoder's widths beyond n_mels (the JAX bench's defaults); tests
# shrink them
MODEL_CONFIG = dict(num_layers=3, hidden_size=256, output_size=256)
WARM_STEPS = 3
LR = 1e-4


def build_train_step(speakers: int, utts: int, frames: int, n_mels: int,
                     device: torch.device, dtype: str = "float32"):
    """(step, state, batch) of the bench's encoder in ``dtype`` and
    batch."""
    rng = np.random.default_rng(0)
    batch = {"utterances": torch.as_tensor(rng.standard_normal(
        (speakers * utts, frames, n_mels)).astype(np.float32),
        device=device)}
    model = LSTMSpeakerEncoder(
        n_mels=n_mels, **MODEL_CONFIG,
        **resolve_model_kwargs({"dtype": dtype}))
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model.to(device)
    opt = build_optimizer(model.parameters(), "adam", LR)
    state = init_ge2e_train_state(model, opt)
    return make_ge2e_train_step(model, opt, speakers), state, batch


def run(speakers: int, utts: int, frames: int, n_mels: int, iters: int,
        device: torch.device, dtype: str = "float32") -> dict:
    """Time ``iters`` steps in ``dtype``; returns the record."""
    step, state, batch = build_train_step(speakers, utts, frames, n_mels,
                                          device, dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(1 + WARM_STEPS):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    sync()
    tic = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])               # waits for the device
    sync()
    avg = (time.perf_counter() - tic) / iters
    if not np.isfinite(loss):
        raise AssertionError(f"ge2e: non-finite loss {loss}")
    flops = ge2e_train_flops(speakers * utts, frames, n_mels=n_mels,
                             **MODEL_CONFIG)
    name, limit = card(device)
    return {"metric": "ge2e_train_avg_ips", "speakers": speakers,
            "utts_per_speaker": utts, "value": speakers * utts / avg,
            "unit": "utterances/sec", "ms_per_step": 1e3 * avg,
            "frames": frames, "n_mels": n_mels, "dtype": dtype,
            "flops_per_step": flops, "loss": loss,
            "backend": device.type, "tf32": tf32_enabled(), "device": name,
            "power_limit": limit,
            **mfu_stats(flops, avg, name)}


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed record."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--speakers", type=int, default=64)
    parser.add_argument("--utts", type=int, default=10)
    parser.add_argument("--frames", type=int, default=160)
    parser.add_argument("--n-mels", type=int, default=40)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype (bfloat16: float32 weights)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    record = run(args.speakers, args.utts, args.frames, args.n_mels,
                 args.iters, device, args.dtype)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
