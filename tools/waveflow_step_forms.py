"""What WaveFlow's training step costs with each form of its full-grid
convolution, with cuDNN and in the recipes' bitwise-resume setting.

``models/waveflow.py`` computes each layer's height-causal, width-dilated
3 x 3 convolution as one ``Conv2d`` on the (B, C, h, W) view of its
channels-last grid (``WaveFlowResidualBlock.grid_conv``), which PyTorch
sends to cuDNN or, with cuDNN off
(``training/seeding.py::deterministic_training``, the recipes' setting),
to its native convolution.  The other form, ``taps_form`` here, writes it
as products of its taps: one (B h W', C) x (C, kw 2C) cuBLAS GEMM a
height tap over the padded width W', whose kw column blocks are summed
at their width offsets through a strided view; it needs no cuDNN and no
per-sample im2col.

On the card, at the widths of recipes/waveflow/conf/default.yaml and
``benchmarks/train_am.py``'s WaveFlow batch (8 clips of 65 frames, a
16 x 1,040 grid, float32 with TF32 off), this checks first that the two
forms' forwards agree (z and logs_sum within 1e-4 of their range), then
times the Adam train step of each form under PyTorch's defaults and
under ``deterministic_training``, in turns (conv2d, taps, taps, conv2d),
``--steps`` synchronised steps a turn after 2 warm ones, each from the
same weights, and prints the median wall ms a step and the peak memory
of each.  The card's name and power limit come first, as ``nvidia-smi``
gives them.

Usage (on the card, from the repository's root):
    python3 tools/waveflow_step_forms.py [--steps 5]
"""
import argparse
import contextlib
import pathlib
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from parakeet_tpu_torch.benchmarks import train_am  # noqa: E402
from parakeet_tpu_torch.models.waveflow import \
    WaveFlowResidualBlock  # noqa: E402
from parakeet_tpu_torch.training import deterministic_training  # noqa: E402

FORWARD_REL_TOL = 1e-4


def taps_form(block, x):
    """``grid_conv``'s function as tap products: x (B, h, W, C) ->
    (B, h, W, 2C).  Height tap i reads rows [i dh, i dh + h) of the padded
    grid, a view of (B, h W', C), in one product with the kw width taps'
    weights side by side; width tap j of output column x is that
    product's block j at padded column x + j dw."""
    kh, kw = block.kernel_size
    b, rows, w, c = x.shape
    w_pad = (kw - 1) * block.dilation_w // 2
    xp = F.pad(x, (0, 0, w_pad, w_pad, block.buffer_rows, 0))
    wide = w + 2 * w_pad
    weight = block.conv.weight                     # (2C, C, kh, kw)
    out = block.conv.bias
    for i in range(kh):
        r0 = i * block.dilation_h
        taps = weight[:, :, i].permute(1, 2, 0).reshape(c, -1)
        y = xp[:, r0:r0 + rows].reshape(b, rows * wide, c) @ taps
        s0, s1, s2 = rows * wide * kw * 2 * c, wide * kw * 2 * c, kw * 2 * c
        shifted = y.as_strided((b, rows, w, kw, 2 * c),
                               (s0, s1, s2, block.dilation_w * s2 + 2 * c, 1))
        out = out + shifted.sum(3)
    return out


@contextlib.contextmanager
def form(name):
    """The convolution form ``name`` ("conv2d", the model's, or "taps")
    in every residual block, inside the block."""
    conv2d = WaveFlowResidualBlock.grid_conv
    if name == "taps":
        WaveFlowResidualBlock.grid_conv = taps_form
    try:
        yield
    finally:
        WaveFlowResidualBlock.grid_conv = conv2d


def time_steps(name, deterministic, steps, device):
    """Median wall ms of the train step in form ``name`` and setting, and
    the peak GiB allocated."""
    step, state, batch = train_am.build_train_step("waveflow", 8, 96, 640,
                                                   device)
    setting = (deterministic_training() if deterministic
               else contextlib.nullcontext())
    times = []
    with form(name), setting:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            tic = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])
            times.append(1e3 * (time.perf_counter() - tic))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2**30


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    device = torch.device("cuda")
    _, state, batch = train_am.build_train_step("waveflow", 8, 96, 640,
                                                device)
    model = state.modules["model"]
    with torch.no_grad():
        want = model(batch["wav"], batch["mel"])
        with form("taps"):
            got = model(batch["wav"], batch["mel"])
    for part, g, w in zip(("z", "logs_sum"), got, want):
        err = (g - w).abs().max().item()
        tol = FORWARD_REL_TOL * max(w.abs().max().item(), 1.0)
        if not err <= tol:
            raise AssertionError(f"{part}: taps against conv2d {err} > {tol}")
        print(f"forward {part}: taps against conv2d max abs err {err:.4g} "
              f"(tol {tol:.4g})")
    for deterministic in (False, True):
        runs = {"conv2d": [], "taps": []}
        for name in ("conv2d", "taps", "taps", "conv2d"):
            runs[name].append(time_steps(name, deterministic, args.steps,
                                         device))
        print(("deterministic (cuDNN off)" if deterministic else
               "PyTorch's defaults (cuDNN on)") + ": " + "; ".join(
            f"{name} " + ", ".join(f"{ms:.1f} ms ({gib:.1f} GiB)"
                                   for ms, gib in r)
            for name, r in runs.items()), flush=True)


if __name__ == "__main__":
    main()
