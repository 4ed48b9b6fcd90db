"""Thread-pool map of the preprocessing CLIs (counterpart of
``parakeet_tpu/utils/mp_tools.py::thread_map``; reference: the
preprocessors' ThreadPoolExecutor, examples/fastspeech2/preprocess.py:122).
The rank-0 helpers belong to the parallel layer (ROADMAP queue 1, item
18) and are not ported."""
from __future__ import annotations

__all__ = ["thread_map"]


def thread_map(fn, items, num_workers: int = 8):
    """Map ``fn`` over ``items`` with a thread pool, preserving order."""
    from concurrent.futures import ThreadPoolExecutor
    if num_workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(num_workers) as pool:
        return list(pool.map(fn, items))
