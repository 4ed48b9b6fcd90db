"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

The sources in ``parakeet_tpu_torch/csrc/`` have a plain C interface and
include no PyTorch header.  Each ``.cu`` file is compiled by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library.  It goes to ``build/parakeet_tpu_torch/<hash>/`` at
the root of the checkout, keyed by a hash of the sources, the headers and
the flags, and is built on first use, never at import.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libparakeet_kernels.so"


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library, where it lies, the wall seconds ``nvcc`` took in
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: pathlib.Path, lib: pathlib.Path) -> str:
    """Compile every source in parallel, link, and return the log."""
    nvcc = _nvcc()
    objs, procs, log = [], [], []
    work = pathlib.Path(tempfile.mkdtemp(dir=out_dir))  # per build
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(str(obj))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "\n".join(log))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           + "\n".join(log))
    os.replace(tmp, lib)     # atomic: concurrent builds race safely
    shutil.rmtree(work)
    return "\n".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernels' shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        text = _build(out_dir, lib)
        seconds = time.perf_counter() - t0
        log.write_text(text)
    return KernelLibrary(ctypes.CDLL(str(lib)), str(lib), seconds,
                         log.read_text() if log.exists() else "")
