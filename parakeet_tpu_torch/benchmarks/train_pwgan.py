"""PWGAN training-throughput benchmark of the port (counterpart of
``benchmarks/train_pwgan.py``; reference protocol:
tests/benchmark/PWGAN/run_benchmark.sh:24-36 and run_all.sh:34-50).

Runs N training iterations of the recipe's Parallel WaveGAN (the widths of
``recipes/pwgan/conf/default.yaml``, with ``--opts`` overrides) at each batch
size on seeded synthetic batches of ``batch_max_steps`` samples, with the
discriminator on from the first step, and prints one JSON line per batch
size: ``avg_ips = batch_size / avg_batch_cost`` in sequences per second,
the impls, the discriminator's ``disc_vjp`` ('save': K3a saves every
layer's input and K3b reads them; 'recompute': K3c rebuilds them), the
backend and the card's name.  The steps are chained and timed from the
host with one synchronisation at the end.

Usage:
  python -m parakeet_tpu_torch.benchmarks.train_pwgan --disc-vjp recompute \\
      [--stack-impl fused] [--disc-impl auto] [--batch-sizes 6 26] \\
      [--dtype bfloat16] [--iters 20] [--profile DIR] [--device cpu] \\
      [--opts KEY VALUE ...]

``--dtype bfloat16`` sets both networks' compute dtype (mixed precision:
parameters, losses and Adam state stay float32), as the JAX bench.

Not ported from the JAX bench: ``--rng`` (threefry / rbg, a TPU device
generator switch) and the MFU field (its denominator, ``utils/flops.py``, is the TPU
v5e's; an MFU against the H100's peak waits for the analytic FLOP counts
of ROADMAP queue 1 item 17).
"""
import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import (PWGDiscriminator, PWGGenerator, init_pwg_train_state,
                      make_pwg_train_step)
from ..models.parallel_wavegan import init_pwg_params_
from ..training import (Config, build_optimizer, resolve_model_kwargs,
                        seed_everything)
from ..utils.device import (add_device_arg, disable_tf32, set_device,
                            tf32_enabled)

__all__ = ["main", "bench_batch_size", "build_train_step"]

_CONFIG = (Path(__file__).resolve().parents[2] / "recipes" / "pwgan"
           / "conf" / "default.yaml")


def build_train_step(cfg, batch_size: int, *, stack_impl: str,
                     disc_impl: str, disc_vjp: str, device: torch.device,
                     dtype: Optional[str] = None):
    """The recipe's GAN train step at ``batch_size`` with seeded weights
    and ``dtype`` (when given) the networks' compute dtype: (step, state,
    batch), the discriminator on from the first step."""
    dt = {} if dtype is None else {"dtype": dtype}
    gen_kwargs = resolve_model_kwargs(
        {**cfg.generator_params, "stack_impl": stack_impl, **dt},
        compute_dtype=True)
    disc_kwargs = resolve_model_kwargs(
        {**cfg.discriminator_params, "impl": disc_impl,
         "vjp_mode": disc_vjp, **dt}, compute_dtype=True)
    gen = PWGGenerator(**gen_kwargs)
    disc = PWGDiscriminator(**disc_kwargs)
    weights = torch.Generator().manual_seed(0)
    init_pwg_params_(gen, weights)
    init_pwg_params_(disc, weights)
    gen.to(device)
    disc.to(device)
    hop = gen.upsample_factor
    steps = cfg.batch_max_steps - cfg.batch_max_steps % hop
    rng = np.random.default_rng(0)
    batch = {
        "wav": torch.as_tensor(rng.standard_normal(
            (batch_size, steps)).astype(np.float32), device=device),
        "mel": torch.as_tensor(rng.standard_normal(
            (batch_size, steps // hop + 2 * gen.aux_context_window,
             cfg.n_mels)).astype(np.float32), device=device)}
    state = init_pwg_train_state(
        gen, disc, build_optimizer(gen.parameters(), "adam", 1e-4),
        build_optimizer(disc.parameters(), "adam", 5e-5),
        seed_everything(2, device=device))
    stft = cfg.get("stft_loss_params", {})
    step = make_pwg_train_step(
        gen, disc, lambda_adv=4.0, discriminator_train_start_steps=0,
        **{k: tuple(v) for k, v in stft.items()})
    return step, state, batch


def bench_batch_size(cfg, batch_size: int, iters: int, *, stack_impl: str,
                     disc_impl: str, disc_vjp: str, device: torch.device,
                     profile=None, dtype: Optional[str] = None) -> float:
    """Average sequences per second of ``iters`` chained train steps after
    one warm-up step."""
    step, state, batch = build_train_step(
        cfg, batch_size, stack_impl=stack_impl, disc_impl=disc_impl,
        disc_vjp=disc_vjp, device=device, dtype=dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, metrics = step(state, batch)            # warm-up
    float(metrics["generator_loss"])
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = Path(profile)
        out.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                state, metrics = step(state, batch)
            sync()
        name = out / f"train_pwgan_bs{batch_size}_{disc_vjp}"
        prof.export_chrome_trace(f"{name}.json")
        sort = "cuda_time_total" if device.type == "cuda" else \
            "cpu_time_total"
        Path(f"{name}.txt").write_text(prof.key_averages().table(
            sort_by=sort, row_limit=30))
    sync()
    tic = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
    float(metrics["generator_loss"])               # waits for the device
    sync()
    return batch_size * iters / (time.perf_counter() - tic)


def main(argv=None):
    """Run the bench with ``argv`` (default: the command line); returns
    the printed records."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--batch-sizes", type=int, nargs="+",
                        default=[6, 26])
    parser.add_argument("--dtype", default=None,
                        choices=("float32", "bfloat16"),
                        help="compute dtype of both networks (default: the "
                             "config's); parameters, losses and Adam state "
                             "stay float32")
    parser.add_argument("--stack-impl", default="fused",
                        choices=("auto", "eager", "fused", "xla", "pallas"),
                        help="generator residual-stack impl ('fused' trains "
                             "through K2; the JAX names map onto the port's)")
    parser.add_argument("--disc-impl", default="auto",
                        choices=("auto", "eager", "fused", "xla", "pallas"),
                        help="discriminator impl ('auto': fused on the card "
                             "in float32)")
    parser.add_argument("--disc-vjp", default="save",
                        choices=("save", "recompute"),
                        help="fused discriminator's backward: K3b from "
                             "saved inputs or K3c with recompute")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace (.json) and its "
                             "table by kernel (.txt) of 3 steps per batch "
                             "size into DIR")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="KEY VALUE pairs overriding the recipe's "
                             "config (widths, batch_max_steps, STFT losses)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()
    cfg = Config.from_yaml(_CONFIG).merge_opts(args.opts)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    records = []
    for bs in args.batch_sizes:
        ips = bench_batch_size(cfg, bs, args.iters,
                               stack_impl=args.stack_impl,
                               disc_impl=args.disc_impl,
                               disc_vjp=args.disc_vjp, device=device,
                               profile=args.profile, dtype=args.dtype)
        record = {"metric": "pwgan_train_avg_ips", "batch_size": bs,
                  "value": ips, "unit": "sequences/sec",
                  "dtype": args.dtype or str(cfg.generator_params.get(
                      "dtype", "float32")),
                  "stack_impl": args.stack_impl,
                  "disc_impl": args.disc_impl, "disc_vjp": args.disc_vjp,
                  "backend": device.type, "tf32": tf32_enabled(),
                  "device": name}
        print(json.dumps(record))
        records.append(record)
    return records


if __name__ == "__main__":
    main()
