"""FastSpeech2 train steps, dense attention against flash attention (kernel
K4), across decoder lengths, on one GPU.

The points of benchmarks/flash_sweep.py on the PyTorch/CUDA port: the
model of chip_smoke.py's FastSpeech2 phase (adim 384, 4 heads, 4 + 4
layers, float32 with TF32 off, Adam 1e-4) at a constant number of frame
tokens a step (B = tokens / frames), 96 text tokens an utterance where the
frames are a multiple of 96 and 64 otherwise, as flash_sweep.py has it,
and lengths spread as chip_smoke.py spreads them.  At each point the two
models start from the same seeded weights; each takes two warm-up steps,
then they take ``--steps`` steps each in turns (dense, flash, dense, ...),
each timed on the host clock around a synchronised step.

Run from the root of the repository on a machine with a CUDA device:

    python3 fs2_sweep.py [--frames 512 1024 2048 4096 8192] [--steps 6]

It prints the card and the kernel build (chip_smoke.py's first phase),
then one JSON line per point: median ms per step and frame tokens per
second for each core, and the peak device memory of a step above what was
allocated before it (activations and gradients; weights and Adam state
are resident).
"""
import argparse
import json
import statistics
import time

import torch

import chip_smoke as smoke

WARMUP = 2


def build(impl, b, n_frames, n_tokens):
    """A FastSpeech2 train step with attn_impl ``impl``, its state and two
    batches; the same weights and batches for every impl."""
    from parakeet_tpu_torch.models import (FastSpeech2, init_fs2_train_state,
                                           make_fs2_train_step)
    from parakeet_tpu_torch.training import build_optimizer, seed_everything
    gen = torch.Generator().manual_seed(smoke.SEED + 8)
    model = FastSpeech2(smoke.IDIM, smoke.ODIM, attn_impl=impl,
                        **smoke.FS2_TRAIN_CONFIG)
    smoke.seeded_init_(model, gen)
    model = model.cuda()
    batches = smoke.fs2_batches(gen, b, n_frames, n_tokens, steps=2)
    opt = build_optimizer(model.parameters(), "adam", smoke.FS2_LR)
    state = init_fs2_train_state(
        model, opt, seed_everything(smoke.SEED + 9, device="cuda"))
    return make_fs2_train_step(model, opt), state, batches


def timed_step(step, state, batch):
    """(wall ms, peak bytes above the allocation before the step)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    return (1e3 * (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() - base)


def sweep_point(n_frames, tokens, steps):
    b = max(1, tokens // n_frames)
    n_tokens = 96 if n_frames % 96 == 0 else 64
    impls = ("dense", "flash")
    runs = {impl: build(impl, b, n_frames, n_tokens) for impl in impls}
    ms = {impl: [] for impl in impls}
    peak = dict.fromkeys(impls, 0)
    for i in range(WARMUP + steps):
        for impl in impls:
            step, state, batches = runs[impl]
            t, p = timed_step(step, state, batches[i % len(batches)])
            peak[impl] = max(peak[impl], p)
            if i >= WARMUP:
                ms[impl].append(t)
    row = {"frames": n_frames, "batch_size": b, "text_tokens": n_tokens,
           "steps": steps}
    for impl in impls:
        med = statistics.median(ms[impl])
        row[f"{impl}_ms"] = med
        row[f"{impl}_ms_range"] = [min(ms[impl]), max(ms[impl])]
        row[f"{impl}_frame_tokens_per_s"] = b * n_frames / (med / 1e3)
        row[f"{impl}_step_peak_gb"] = peak[impl] / 1e9
    row["flash_over_dense"] = row["flash_ms"] / row["dense_ms"]
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, nargs="+",
                        default=[512, 1024, 2048, 4096, 8192])
    parser.add_argument("--tokens", type=int, default=16384,
                        help="frame tokens a step (batch = tokens / frames)")
    parser.add_argument("--steps", type=int, default=6,
                        help="timed steps per core and point")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fs2_sweep.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_card()
    for n_frames in args.frames:
        print(json.dumps(sweep_point(n_frames, args.tokens, args.steps)),
              flush=True)


if __name__ == "__main__":
    main()
