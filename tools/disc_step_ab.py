"""The PWGAN GAN step with this checkout's kernel K3a against another
checkout's, in one process and one trainer, on one CUDA card.

    python3 tools/disc_step_ab.py DIR [--blocks 10] [--steps 10]

DIR holds a ``parakeet_tpu_torch`` package (the parent commit unpacked
with ``git archive``).  The script builds the training bench's step at
batch 8 with 'save' (``benchmarks/train_pwgan.build_train_step``) and runs
blocks of steps in turns, the discriminator's forward being this
checkout's ``fused_disc_forward`` in one block and DIR's in the next, the
side that runs first alternating.  For each block it prints the wall ms a
step (to the end of a synchronise) and the host's ms a step to issue the
block: where the two agree, the host sets the step's pace and the card
waits for it.  Only K3a differs between the sides; everything else is
this checkout's, in one process, so the comparison is free of the spread
between processes.
"""
import argparse
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from parakeet_tpu_torch.benchmarks import train_pwgan  # noqa: E402
from parakeet_tpu_torch.ops.kernels import pwg_disc  # noqa: E402
from parakeet_tpu_torch.training import Config  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dir", metavar="DIR")
    parser.add_argument("--blocks", type=int, default=10,
                        help="timed blocks a side (after one a side of "
                             "warm-up)")
    parser.add_argument("--steps", type=int, default=10,
                        help="train steps a block")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    chip_smoke.load_parent(args.dir)
    sides = {"change": pwg_disc.fused_disc_forward,
             "parent": chip_smoke.parent_module("pwg_disc")
             .fused_disc_forward}
    cfg = Config.from_yaml(train_pwgan._CONFIG)
    step, state, batch = train_pwgan.build_train_step(
        cfg, 8, stack_impl="fused", disc_impl="auto", disc_vjp="save",
        device=torch.device("cuda"))
    wall = {side: [] for side in sides}
    host = {side: [] for side in sides}
    try:
        for block in range(args.blocks + 1):
            order = list(sides) if block % 2 else list(sides)[::-1]
            for side in order:
                pwg_disc.fused_disc_forward = sides[side]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    state, metrics = step(state, batch)
                t1 = time.perf_counter()
                float(metrics["generator_loss"])
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if block > 0:
                    wall[side].append(1e3 * (t2 - t0) / args.steps)
                    host[side].append(1e3 * (t1 - t0) / args.steps)
    finally:
        pwg_disc.fused_disc_forward = sides["change"]
    for side in sides:
        print(f"{side}: wall ms a step " + ", ".join(
            f"{x:.2f}" for x in wall[side])
            + f" (median {statistics.median(wall[side]):.3f}); host ms a "
            "step to issue " + ", ".join(f"{x:.2f}" for x in host[side])
            + f" (median {statistics.median(host[side]):.3f})")
    ahead = sum(c < p for c, p in zip(wall["change"], wall["parent"]))
    print(f"the change's block faster in {ahead} of {args.blocks} pairs")


if __name__ == "__main__":
    main()
