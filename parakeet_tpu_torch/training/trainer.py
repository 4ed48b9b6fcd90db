"""The training loop (counterpart of ``parakeet_tpu/training/trainer.py``).

Same architecture as the reference's Trainer (reference:
parakeet/training/trainer.py:40-213): while not stop_trigger, run
updater.update(), then fire extensions in priority order within an
observation scope; exceptions call extensions' on_error then re-raise.
Per-iteration the trainer logs reader cost, batch cost, and ips — the same
``avg_ips`` metric the reference's benchmark harness parses
(tests/benchmark/PWGAN/run_benchmark.sh).
"""
from __future__ import annotations

import logging
import sys
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..utils.profiler import (ProfilerOptions, add_profiler_step,
                              stop_profiler)
from .extension import PRIORITY_READER
from .reporter import scope
from .triggers import get_trigger
from .updater import UpdaterBase

__all__ = ["Trainer", "ExtensionEntry"]

logger = logging.getLogger(__name__)


@dataclass
class ExtensionEntry:
    extension: Callable
    trigger: Callable
    priority: int
    name: str = ""


class Trainer:
    def __init__(self,
                 updater: UpdaterBase,
                 stop_trigger=None,
                 out: str = "output",
                 extensions: Optional[List] = None,
                 log_interval: int = 1,
                 profiler_options: Optional[str] = None,
                 config=None):
        self.updater = updater
        self.stop_trigger = get_trigger(stop_trigger)
        self.out = Path(out)
        self.extensions: "OrderedDict[str, ExtensionEntry]" = OrderedDict()
        self.observation: Dict = {}
        self.log_interval = log_interval
        self.profiler_options = (
            ProfilerOptions(profiler_options)
            if isinstance(profiler_options, str) else profiler_options)
        self.config = config
        self._done = False
        for ext in extensions or []:
            self.extend(ext)

    def setup(self) -> None:
        self.out.mkdir(parents=True, exist_ok=True)
        if self.config is not None and hasattr(self.config, "dump"):
            # reproducibility record of the exact merged hyperparameters
            self.config.dump(self.out / "config.yaml")
        # per-rank text log in the output dir (reference writes
        # worker_{rank}.log, experiment.py:233-246); handler removed
        # in run()'s finally so sequential Trainers don't cross-write
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        path = (self.out / f"worker_{rank}.log").resolve()
        root = logging.getLogger()
        self._log_handler = None
        self._prev_root_level = root.level
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == str(path)
                   for h in root.handlers):
            handler = logging.FileHandler(path)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            handler.setLevel(logging.INFO)
            root.addHandler(handler)
            self._log_handler = handler
            if root.level > logging.INFO:
                root.setLevel(logging.INFO)

    def extend(self, extension, name: Optional[str] = None, trigger=None,
               priority: Optional[int] = None) -> None:
        """Register an extension, resolving trigger/priority/name."""
        if trigger is None:
            trigger = getattr(extension, "trigger", (1, "iteration"))
        trigger = get_trigger(trigger)
        if priority is None:
            priority = getattr(extension, "priority", PRIORITY_READER)
        if name is None:
            name = getattr(extension, "name", None) or getattr(
                extension, "default_name", None) or getattr(
                extension, "__name__", "extension")
        original = name
        suffix = 0
        while name in self.extensions:
            suffix += 1
            name = f"{original}_{suffix}"
        self.extensions[name] = ExtensionEntry(
            extension, trigger, priority, name)

    def _sorted_extensions(self) -> List[ExtensionEntry]:
        return sorted(self.extensions.values(),
                      key=lambda e: e.priority, reverse=True)

    def run(self) -> None:
        if self._done:
            raise RuntimeError("Training done already, cannot run again.")
        self.setup()

        for entry in self._sorted_extensions():
            if hasattr(entry.extension, "initialize"):
                entry.extension.initialize(self)

        extensions = self._sorted_extensions()
        # prime interval triggers to the (possibly resumed) state so the
        # first in-loop check fires on progress made THIS run — neither
        # swallowing an epoch completed by the first iteration nor
        # re-firing for the epoch a resumed snapshot already handled
        for entry in extensions:
            prime = getattr(entry.trigger, "prime", None)
            if prime is not None:
                prime(self)
        update = self.updater.update

        max_iteration = getattr(self.stop_trigger, "limit", None) \
            if getattr(self.stop_trigger, "unit", None) == "iteration" \
            else None

        batch_cost_sum = 0.0
        reader_cost_sum = 0.0
        window = 0
        try:
            while not self.stop_trigger(self):
                self.observation = {}
                add_profiler_step(self.profiler_options,
                                  self.updater.state.iteration)
                with scope(self.observation):
                    tic = time.time()
                    update()
                    batch_cost_sum += time.time() - tic
                    reader_cost_sum += getattr(
                        self.updater, "last_reader_cost", 0.0)
                    window += 1

                    if window >= self.log_interval:
                        iteration = self.updater.state.iteration
                        avg_batch = batch_cost_sum / window
                        avg_reader = reader_cost_sum / window
                        # ips: observations may carry a batch size report
                        bs = next(
                            (v for k, v in self.observation.items()
                             if k == "batch_size"
                             or k.endswith("/batch_size")), None)
                        msg = f"iter: {iteration}"
                        if max_iteration:
                            msg += f"/{max_iteration}"
                        metrics = ", ".join(
                            f"{k}: {float(v):>.6f}"
                            for k, v in self.observation.items()
                            if _is_scalar(v))
                        msg += f", {metrics}" if metrics else ""
                        msg += (f", avg_reader_cost: {avg_reader:.5f} sec,"
                                f" avg_batch_cost: {avg_batch:.5f} sec")
                        if bs is not None:
                            msg += (f", avg_ips: {float(bs) / avg_batch:.5f}"
                                    " sequences/sec")
                        logger.info(msg)
                        reader_cost_sum = batch_cost_sum = 0.0
                        window = 0

                    for entry in extensions:
                        if entry.trigger(self):
                            entry.extension(self)
        except Exception as e:
            traceback.print_exc()
            for entry in extensions:
                if hasattr(entry.extension, "on_error"):
                    entry.extension.on_error(self, e, sys.exc_info()[2])
            raise
        finally:
            # training ended inside the trace window: stop so the trace
            # is actually written
            stop_profiler(self.profiler_options)
            if getattr(self, "_log_handler", None) is not None:
                root = logging.getLogger()
                root.removeHandler(self._log_handler)
                self._log_handler.close()
                self._log_handler = None
                root.setLevel(self._prev_root_level)
            for entry in extensions:
                if hasattr(entry.extension, "finalize"):
                    entry.extension.finalize(self)
            self._done = True


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
