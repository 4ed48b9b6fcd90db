"""Device selection for the port's CLIs (counterpart of
``parakeet_tpu/utils/device.py``; reference: parakeet/training/cli.py:17
exposes --device on every entry point).  The default is the card; the CPU
is for tests and runs only when asked for."""
from __future__ import annotations

import torch

__all__ = ["add_device_arg", "set_device", "disable_tf32", "tf32_enabled"]


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="compute device (default: cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")


def set_device(device: str) -> torch.device:
    """The torch device of a ``--device`` value.  'cuda' without a card
    raises: a run never carries on on the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}")
    return torch.device(device)


def disable_tf32() -> None:
    """Run float32 products as float32 on the card: TF32 off in cuBLAS's
    matmuls and cuDNN's convolutions (PyTorch leaves cuDNN's on), as
    ``chip_smoke.py`` runs.  The benches and CLIs call it in ``main``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_enabled() -> bool:
    """Whether any float32 product may run in TF32 (a record's ``tf32``)."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
