"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

The sources in ``parakeet_tpu_torch/csrc/`` have a plain C interface and
include no PyTorch header, so one ``nvcc`` call builds them in seconds.
The shared library goes to ``build/parakeet_tpu_torch/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and the flags, and
is built on first use, never at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["KernelLibrary", "load_library", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "parakeet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libparakeet_kernels.so"


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library, where it lies, the seconds ``nvcc`` took in
    this process (0.0 when the build was cached) and ``nvcc``'s log."""
    cdll: ctypes.CDLL
    path: str
    build_seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "parakeet_tpu_torch are built on a machine with the "
                       "CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernels' shared library."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, lib)     # atomic: concurrent builders race safely
    return KernelLibrary(ctypes.CDLL(str(lib)), str(lib), seconds,
                         log.read_text() if log.exists() else "")
