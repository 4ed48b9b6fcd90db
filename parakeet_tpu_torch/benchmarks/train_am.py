"""Per-family training throughput of the port (counterpart of
``benchmarks/train_am.py``; reference: the trainer's ``avg_ips`` log line,
parakeet/training/trainer.py:160-168).

N training steps of a family's model at the JAX bench's shapes (batch 32,
96 tokens, 640 frames, every utterance full length; SpeedySpeech's
durations frames // 96 with the rest on the last token; WaveFlow batch 8
of 65-frame clips, 16,640 samples) and widths (Tacotron2: the JAX
module's defaults, 1024-wide LSTMs, 640 decoder steps; SpeedySpeech: 128
wide, 8 tones; TransformerTTS and WaveFlow: their recipes' YAMLs,
``TRANSFORMER_TTS_CONFIG`` and ``WAVEFLOW_CONFIG``, where the JAX bench
builds the modules' defaults), float32 or with ``--dtype bfloat16``
flax's mixed precision (float32 parameters and Adam state, bf16 products;
``nn/precision.py``), Adam (1e-3; WaveFlow 2e-4), with
flax's initializers drawn from seed 0 (WaveFlow's output projections
then drawn N(0, 0.01^2) too, so that its flows are not the identity).  Prints one JSON line a
family: ``value = batch_size / avg_batch_cost`` in sequences per second
under the JAX bench's metric name ``<family>_train_avg_ips``, with the
ms a step, the backend, the card's name and power limit.  One step and 3
warm-up steps (``--warmup``) run first; then ``--iters`` chained steps
are timed from the host, with one synchronisation at the end.
``--deterministic`` trains under ``deterministic_training``, the setting of the recipes'
bitwise resume (PyTorch's deterministic algorithms, cuDNN off), so that
its cost shows beside the default.

Usage:
  python -m parakeet_tpu_torch.benchmarks.train_am \\
      [--models tacotron2 speedyspeech] [--iters 20] [--warmup 3] \\
      [--deterministic] [--batch-size 32] [--text-len 96] [--frames 640] \\
      [--dtype float32|bfloat16] [--device cpu]

Every leg of the JAX bench runs: ``tacotron2``, ``transformer_tts``,
``speedyspeech`` and ``waveflow``.  Not ported: ``--rng rbg`` (a TPU
device generator), refused with a message.
"""
import argparse
import contextlib
import json
import time
from typing import Optional

import numpy as np
import torch

from ..models import (SpeedySpeech, Tacotron2, TransformerTTS,
                      init_speedyspeech_train_state, init_tacotron2_,
                      init_tacotron2_train_state, init_transformer_tts_,
                      init_transformer_tts_train_state,
                      init_waveflow_train_state,
                      make_speedyspeech_train_step,
                      make_tacotron2_train_step,
                      make_transformer_tts_train_step,
                      make_waveflow_train_step)
from ..nn.initializer import init_flax_defaults_
from ..training import (build_optimizer, deterministic_training,
                        resolve_model_kwargs, seed_everything)
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)
from .common import (TRANSFORMER_TTS_CONFIG, WAVEFLOW_CONFIG, card,
                     seeded_waveflow)

__all__ = ["main", "build_train_step", "FAMILIES", "MODEL_CONFIGS"]

FAMILIES = ("tacotron2", "transformer_tts", "speedyspeech", "waveflow")
# each family's constructor arguments beyond the JAX bench's (Tacotron2
# and SpeedySpeech: none, their defaults; TransformerTTS and WaveFlow:
# their recipes' widths); tests shrink them
MODEL_CONFIGS = {"tacotron2": {}, "speedyspeech": {},
                 "transformer_tts": TRANSFORMER_TTS_CONFIG,
                 "waveflow": WAVEFLOW_CONFIG}
VOCAB, TONES, ODIM = 80, 8, 80
# WaveFlow's batch: the reference protocol's 8 clips of 65 frames
# (recipes/waveflow/conf/default.yaml), hop 256
WAVEFLOW_B, WAVEFLOW_FRAMES = 8, 65
WARM_STEPS = 3


def check_family(name: str) -> None:
    """Raise unless ``name`` is a family of the JAX bench."""
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}")


def build_train_step(name: str, batch_size: int, text_len: int,
                     frames: int, device: torch.device,
                     dtype: Optional[torch.dtype] = None):
    """(step, state, batch) of family ``name`` at the bench's shapes,
    computing in flax's ``dtype`` (None: float32)."""
    check_family(name)
    b, t = batch_size, text_len
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    text_batch = {"text": rng.integers(1, VOCAB, (b, t)),
                  "text_lengths": np.full(b, t),
                  "speech": rng.standard_normal((b, frames, ODIM)).astype(
                      np.float32),
                  "speech_lengths": np.full(b, frames)}
    lr = 1e-3
    if name == "tacotron2":
        model = Tacotron2(vocab_size=VOCAB, dtype=dtype,
                          **MODEL_CONFIGS[name])
        init_tacotron2_(model, gen)
        batch = text_batch
        make_step, init_state = (make_tacotron2_train_step,
                                 init_tacotron2_train_state)
    elif name == "transformer_tts":
        model = TransformerTTS(idim=VOCAB, odim=ODIM, dtype=dtype,
                               **MODEL_CONFIGS[name])
        init_transformer_tts_(model, gen)
        batch = text_batch
        make_step, init_state = (make_transformer_tts_train_step,
                                 init_transformer_tts_train_state)
    elif name == "waveflow":
        model = seeded_waveflow({**MODEL_CONFIGS[name], "dtype": dtype},
                                gen)
        hop = model.encoder.upsample_factor
        batch = {"wav": 0.1 * rng.standard_normal(
                     (WAVEFLOW_B, WAVEFLOW_FRAMES * hop)).astype(np.float32),
                 "mel": rng.standard_normal(
                     (WAVEFLOW_B, WAVEFLOW_FRAMES,
                      MODEL_CONFIGS[name].get("n_mels", ODIM))
                 ).astype(np.float32)}
        lr = 2e-4
        make_step, init_state = (make_waveflow_train_step,
                                 init_waveflow_train_state)
    else:
        model = SpeedySpeech(vocab_size=VOCAB, tone_size=TONES, dtype=dtype,
                             **MODEL_CONFIGS[name])
        init_flax_defaults_(model, gen)
        durations = np.full((b, t), frames // t, np.int64)
        durations[:, -1] += frames - durations[0].sum()
        batch = {"phones": rng.integers(1, VOCAB, (b, t)),
                 "tones": rng.integers(0, TONES, (b, t)),
                 "durations": durations,
                 "feats": rng.standard_normal((b, frames, ODIM)).astype(
                     np.float32),
                 "num_phones": np.full(b, t), "num_frames": np.full(b, frames)}
        make_step, init_state = (make_speedyspeech_train_step,
                                 init_speedyspeech_train_state)
    model.to(device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    opt = build_optimizer(model.parameters(), "adam", lr)
    state = init_state(model, opt, seed_everything(0, device=device))
    return make_step(model, opt), state, batch


def bench_family(name: str, iters: int, batch_size: int, text_len: int,
                 frames: int, device: torch.device,
                 deterministic: bool, dtype: str = "float32",
                 warmup: int = WARM_STEPS) -> dict:
    """Time ``iters`` steps of family ``name`` in ``dtype`` after 1 +
    ``warmup`` steps; returns the record."""
    step, state, batch = build_train_step(
        name, batch_size, text_len, frames, device,
        resolve_model_kwargs({"dtype": dtype}).get("dtype"))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    setting = (deterministic_training() if deterministic
               else contextlib.nullcontext())
    with setting:
        for _ in range(1 + warmup):
            state, metrics = step(state, batch)
        float(metrics["loss"])
        sync()
        tic = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state, batch)
        loss = float(metrics["loss"])           # waits for the device
        sync()
    avg = (time.perf_counter() - tic) / iters
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss {loss}")
    name_, limit = card(device)
    if name == "waveflow":
        batch_size, text_len, frames = WAVEFLOW_B, None, WAVEFLOW_FRAMES
    return {"metric": f"{name}_train_avg_ips", "batch_size": batch_size,
            "value": batch_size / avg, "unit": "sequences/sec",
            "ms_per_step": 1e3 * avg, "dtype": dtype, "rng": "threefry",
            "deterministic": deterministic, "text_len": text_len,
            "frames": frames, "backend": device.type,
            "tf32": tf32_enabled(), "device": name_,
            "power_limit": limit}


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--models", nargs="+", default=list(FAMILIES))
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=WARM_STEPS,
                        help="warm-up steps after the first")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--text-len", type=int, default=96)
    parser.add_argument("--frames", type=int, default=640)
    parser.add_argument("--deterministic", action="store_true",
                        help="train under the recipes' bitwise-resume "
                             "setting (deterministic algorithms, cuDNN off)")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype (bfloat16: float32 parameters)")
    parser.add_argument("--rng", default="threefry",
                        choices=("threefry", "rbg"),
                        help="the JAX bench's device generator; 'rbg' is "
                             "the TPU's and is refused")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.rng != "threefry":
        raise NotImplementedError("--rng rbg is a TPU device generator; "
                                  "the port draws from a torch.Generator")
    for name in args.models:
        check_family(name)
    device = set_device(args.device)
    disable_tf32()
    records = []
    for name in args.models:
        records.append(bench_family(name, args.iters, args.batch_size,
                                    args.text_len, args.frames, device,
                                    args.deterministic, args.dtype,
                                    args.warmup))
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
