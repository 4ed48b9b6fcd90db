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
each timed on the host clock around a synchronised step.  Then each
model's no-grad ``inference`` at ``max_frames`` = the point's frames, with
the batch's durations (so both decoders run the same lengths), is timed
the same way: two warm-up calls, then ``--steps`` calls each in turns.

Run from the root of the repository on a machine with a CUDA device:

    python3 fs2_sweep.py [--frames 512 1024 2048 4096 8192] [--steps 6] \
        [--adim 384] [--aheads 4] [--engine]

``--aheads 2`` runs the model at the FastSpeech2 recipes' head width
(adim 384 over 2 heads, dk 192) instead of flash_sweep.py's 4 (dk 96);
``--adim 512 --aheads 2`` at dk 256, ``--aheads 1`` at dk 384 and
``--adim 512 --aheads 1`` at dk 512 (the other widths as they are).

It prints the card and the kernel build (chip_smoke.py's first phase),
then one JSON line per point: median ms per step and frame tokens per
second for each core, the peak device memory of a step above what was
allocated before it (activations and gradients; weights and Adam state
are resident), and median ms per inference call for each core.

``--engine`` also times chip_smoke.py's serving engine (bf16, the
recipes' widths, dk 192, one CUDA graph a grid point) with attn_impl
'dense' against 'flash': one chunk of 128 tokens (1,024 frames) at
batch 1 and at batch 4, ``--steps`` rounds of dense, flash, flash, dense,
and prints one JSON line per batch with the median wall ms a chunk.
"""
import argparse
import json
import statistics
import time

import torch

import chip_smoke as smoke

WARMUP = 2


def build(impl, b, n_frames, n_tokens, config):
    """A FastSpeech2 train step with attn_impl ``impl`` and ``config``, its
    state, two batches and the model; the same weights and batches for
    every impl."""
    from parakeet_tpu_torch.models import (FastSpeech2, init_fs2_train_state,
                                           make_fs2_train_step)
    from parakeet_tpu_torch.training import build_optimizer, seed_everything
    gen = torch.Generator().manual_seed(smoke.SEED + 8)
    model = FastSpeech2(smoke.IDIM, smoke.ODIM, attn_impl=impl, **config)
    smoke.seeded_init_(model, gen)
    model = model.cuda()
    batches = smoke.fs2_batches(gen, b, n_frames, n_tokens, steps=2)
    opt = build_optimizer(model.parameters(), "adam", smoke.FS2_LR)
    state = init_fs2_train_state(
        model, opt, seed_everything(smoke.SEED + 9, device="cuda"))
    return make_fs2_train_step(model, opt), state, batches, model


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


def sweep_point(n_frames, tokens, steps, config):
    b = max(1, tokens // n_frames)
    n_tokens = 96 if n_frames % 96 == 0 else 64
    impls = ("dense", "flash")
    runs = {impl: build(impl, b, n_frames, n_tokens, config)
            for impl in impls}
    ms = {impl: [] for impl in impls}
    peak = dict.fromkeys(impls, 0)
    for i in range(WARMUP + steps):
        for impl in impls:
            step, state, batches, _ = runs[impl]
            t, p = timed_step(step, state, batches[i % len(batches)])
            peak[impl] = max(peak[impl], p)
            if i >= WARMUP:
                ms[impl].append(t)
    row = {"frames": n_frames, "batch_size": b, "text_tokens": n_tokens,
           "adim": config["adim"], "aheads": config["aheads"],
           "steps": steps}
    for impl in impls:
        med = statistics.median(ms[impl])
        row[f"{impl}_ms"] = med
        row[f"{impl}_ms_range"] = [min(ms[impl]), max(ms[impl])]
        row[f"{impl}_frame_tokens_per_s"] = b * n_frames / (med / 1e3)
        row[f"{impl}_step_peak_gb"] = peak[impl] / 1e9
    row["flash_over_dense"] = row["flash_ms"] / row["dense_ms"]
    infer_ms = {impl: [] for impl in impls}
    for i in range(WARMUP + steps):
        for impl in impls:
            _, _, batches, model = runs[impl]
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                model.inference(batch["text"], batch["text_lengths"],
                                max_frames=n_frames,
                                durations=batch["durations"])
            torch.cuda.synchronize()
            if i >= WARMUP:
                infer_ms[impl].append(1e3 * (time.perf_counter() - t0))
    for impl in impls:
        row[f"{impl}_infer_ms"] = statistics.median(infer_ms[impl])
    row["infer_flash_over_dense"] = (row["flash_infer_ms"]
                                     / row["dense_infer_ms"])
    return row


ENGINE_TOKENS, ENGINE_BATCHES = 128, (1, 4)


def engine_points(steps):
    """The graph engine's 128-token chunk, 'dense' against 'flash', in
    turns; one row a batch size."""
    from parakeet_tpu_torch.serving import Request
    grid = dict(batch_buckets=smoke.GRAPH_BATCH_BUCKETS,
                frames_per_token=smoke.GRAPH_FRAMES_PER_TOKEN)
    impls = ("dense", "flash")
    engines = {impl: smoke.build_engine(graphs=True, attn_impl=impl, **grid)
               for impl in impls}
    for engine in engines.values():
        engine.warmup()
    gen = torch.Generator().manual_seed(smoke.SEED + 2)
    rows = []
    for batch in ENGINE_BATCHES:
        reqs = [Request(ids=torch.randint(1, smoke.IDIM, (ENGINE_TOKENS,),
                                          generator=gen).tolist(),
                        utt_id=f"u{i}", seed=100 + i) for i in range(batch)]
        ms = {impl: [] for impl in impls}
        for i in range(WARMUP + steps):
            for impl in (impls if i % 2 == 0 else impls[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[impl].synthesize(reqs)
                if i >= WARMUP:
                    ms[impl].append(1e3 * (time.perf_counter() - t0))
        row = {"engine_chunk_tokens": ENGINE_TOKENS, "batch_size": batch,
               "frames": ENGINE_TOKENS * smoke.GRAPH_FRAMES_PER_TOKEN,
               "dtype": "bfloat16", "steps": steps}
        for impl in impls:
            row[f"{impl}_ms"] = statistics.median(ms[impl])
            row[f"{impl}_ms_range"] = [min(ms[impl]), max(ms[impl])]
        row["flash_over_dense"] = row["flash_ms"] / row["dense_ms"]
        rows.append(row)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, nargs="+",
                        default=[512, 1024, 2048, 4096, 8192])
    parser.add_argument("--tokens", type=int, default=16384,
                        help="frame tokens a step (batch = tokens / frames)")
    parser.add_argument("--steps", type=int, default=6,
                        help="timed steps per core and point")
    parser.add_argument("--adim", type=int, default=384,
                        help="attention width (512 with --aheads 2: dk "
                             "256)")
    parser.add_argument("--aheads", type=int, default=4,
                        help="attention heads of adim (2 at adim 384: the "
                             "recipes' dk 192; 1: dk 384)")
    parser.add_argument("--engine", action="store_true", default=False,
                        help="also time the serving engine's 128-token "
                             "chunk, dense against flash")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fs2_sweep.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_card()
    config = dict(smoke.FS2_TRAIN_CONFIG, adim=args.adim,
                  aheads=args.aheads)
    for n_frames in args.frames:
        print(json.dumps(sweep_point(n_frames, args.tokens, args.steps,
                                     config)), flush=True)
    if args.engine:
        for row in engine_points(args.steps):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
