"""Captured CUDA graphs: the port's counterpart of one compiled XLA program.

On a static shape, one ``torch.cuda.CUDAGraph`` replays what a jitted JAX
program runs: every kernel of one call, from one host call, without the
host's per-op dispatch.  ``CapturedProgram`` captures ``fn`` over
static input buffers that the caller refills before each replay, and
copies each replay's results into output buffers of its own.

A kernel wrapper's launch counter advances while ``fn`` runs eagerly or
is recorded, never when the graph replays: what a replay launches is
read with ``torch.profiler`` (``benchmarks.common.profiled_kernels``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .casts import cast_once

__all__ = ["CapturedProgram"]

# eager runs before a capture: the first builds and loads the kernels and
# creates library handles, the second runs on a warm allocator
WARMUP_RUNS = 2


def _flat(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


class CapturedProgram:
    """``fn(**inputs)`` captured once in a CUDA graph.

    ``inputs``: the static input tensors, on one CUDA device; the caller
    writes each replay's values into them in place.  ``fn`` returns a
    tensor or a tuple of tensors.  It is run ``WARMUP_RUNS`` times on a
    side stream first (library handles, allocator growth, the kernels'
    build and first-use set-up), then recorded under ``torch.no_grad()``
    into a graph whose intermediate memory comes from ``pool`` (a
    ``CUDAGraph.pool()`` handle; None for a private one).  A capture that
    fails raises: there is no eager fallback.

    Graphs that share a pool reuse each other's intermediate memory, so
    they must never run concurrently, and a tensor that a graph allocates
    is valid only until any graph of the pool replays.  So the graph ends
    by copying ``fn``'s results into ``outputs``, buffers allocated
    outside every pool: they hold one replay's results until this
    program's next replay, whatever other graphs of the pool replay in
    between.  ``replays`` counts the replays.

    A module with a compute ``dtype`` (``nn/precision.py``) rounds its
    float32 weights to it in the warm-up runs, inside ``cast_once(casts)``,
    and the graph reads those copies: a replay rounds no weight, and reads
    the weights as they were at the capture.  ``casts`` (a dict; None for
    one of the program's own) may be shared by programs of one model.
    """

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor], *,
                 pool=None, casts: Optional[dict] = None):
        devices = {t.device for t in inputs.values()}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"CapturedProgram needs its inputs on one CUDA "
                             f"device, got {sorted(map(str, devices))}")
        device = next(iter(devices))
        self.inputs = inputs
        self.casts = {} if casts is None else casts
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.no_grad(), \
                cast_once(self.casts):
            for _ in range(WARMUP_RUNS):
                out = fn(**inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self._single = isinstance(out, torch.Tensor)
        self._buffers = tuple(torch.empty_like(t) for t in _flat(out))
        del out
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), cast_once(self.casts), \
                torch.cuda.graph(self.graph, pool=pool):
            for buf, t in zip(self._buffers, _flat(fn(**inputs))):
                buf.copy_(t)
        self.replays = 0

    @property
    def outputs(self):
        """The last replay's results, as ``fn`` returns them."""
        return self._buffers[0] if self._single else self._buffers

    def pool(self):
        """The graph's memory pool, for the next capture to share."""
        return self.graph.pool()

    def __call__(self):
        """Replay the graph on the current stream; returns ``outputs``."""
        self.graph.replay()
        self.replays += 1
        return self.outputs
