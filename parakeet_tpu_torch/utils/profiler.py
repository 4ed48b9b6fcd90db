"""Windowed trace capture (counterpart of
``parakeet_tpu/utils/profiler.py``'s ``ProfilerOptions`` and
``add_profiler_step``) on ``torch.profiler``: a Chrome trace of the CPU and
CUDA activity over a window of training iterations."""
from __future__ import annotations

import pathlib
from typing import Optional

import torch

__all__ = ["ProfilerOptions", "add_profiler_step", "stop_profiler"]


class ProfilerOptions:
    """Parse 'batch_range=[50,60];profile_path=trace_dir;exit_on_finished
    =true' option strings (reference profiler.py:26-80)."""

    def __init__(self, options_str: Optional[str] = None):
        self.batch_range = [10, 20]
        self.profile_path = "profile"
        self.exit_on_finished = False
        if options_str:
            self._parse(options_str)
        self._profiler = None
        self._done = False

    def _parse(self, options_str: str):
        for kv in options_str.replace(" ", "").split(";"):
            if not kv:
                continue
            key, value = kv.split("=", 1)
            if key == "batch_range":
                vals = value.strip("[]").split(",")
                lo, hi = int(vals[0]), int(vals[1])
                if lo < 0 or hi <= lo:
                    raise ValueError(f"invalid batch_range {value}")
                self.batch_range = [lo, hi]
            elif key == "profile_path":
                self.profile_path = value
            elif key == "exit_on_finished":
                self.exit_on_finished = value.lower() in ("1", "true", "yes")


def stop_profiler(options: Optional[ProfilerOptions]) -> None:
    """End an open trace window and write its trace."""
    if options is None or options._profiler is None:
        return
    prof, options._profiler = options._profiler, None
    prof.stop()
    path = pathlib.Path(options.profile_path)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    options._done = True


def add_profiler_step(options: Optional[ProfilerOptions],
                      iteration: int) -> None:
    """Call once per training iteration; starts / stops the trace when the
    iteration window is entered / left."""
    if options is None or options._done:
        return
    lo, hi = options.batch_range
    if options._profiler is None and iteration >= lo:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        options._profiler = torch.profiler.profile(activities=activities)
        options._profiler.start()
    elif options._profiler is not None and iteration >= hi:
        stop_profiler(options)
        if options.exit_on_finished:
            raise SystemExit(0)
