"""Updaters: the training-step abstraction (counterpart of
``parakeet_tpu/training/updater.py``).

The step is a function ``(TrainState, batch) -> (TrainState, metrics)``
(in PyTorch it updates the state's modules and optimizers in place and
returns it); the updater owns the host-side iteration and epoch counters
and the data iterator.  Not ported yet: the mesh (data and tensor
parallelism) and snapshots (``save``/``load``), which wait for the
port's checkpoint module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

from .reporter import report
from .state import TrainState

__all__ = ["UpdaterState", "UpdaterBase", "StandardUpdater"]


@dataclasses.dataclass
class UpdaterState:
    iteration: int = 0
    epoch: int = 0


class UpdaterBase:
    """Protocol: update() performs one training step."""

    def __init__(self):
        self.state = UpdaterState()

    def update(self) -> None:
        raise NotImplementedError

    def state_dict(self):
        return {"iteration": self.state.iteration, "epoch": self.state.epoch}

    def set_state_dict(self, state_dict) -> None:
        self.state.iteration = int(state_dict["iteration"])
        self.state.epoch = int(state_dict["epoch"])


class StandardUpdater(UpdaterBase):
    """One step function over one dataloader.

    Parameters
    ----------
    step_fn : (TrainState, batch) -> (TrainState, metrics dict).
    train_state : the initial TrainState.
    dataloader : iterable of batches; re-iterated each epoch.  If its
        ``batch_sampler`` has ``set_epoch`` it is called on epoch renewal.
    reports_prefix : prepended to metric names in report().
    """

    def __init__(self, step_fn: Callable, train_state: TrainState,
                 dataloader, reports_prefix: str = "train/"):
        super().__init__()
        self.step_fn = step_fn
        self.train_state = train_state
        self.dataloader = dataloader
        self.reports_prefix = reports_prefix
        self._iterator: Optional[Iterator] = None
        self._epoch_count = 0
        self.last_metrics: Dict[str, Any] = {}
        self.last_reader_cost = 0.0

    def read_batch(self):
        if self._iterator is None:
            self._set_epoch()
            self._iterator = iter(self.dataloader)
            self._epoch_count = 0
        try:
            batch = next(self._iterator)
        except StopIteration:
            # fallback for dataloaders without a known length
            self.state.epoch += 1
            self._set_epoch()
            self._iterator = iter(self.dataloader)
            self._epoch_count = 0
            batch = next(self._iterator)
        self._epoch_count += 1
        # an epoch ends AT its last batch (chainer is_new_epoch semantics),
        # so an N-epoch run does exactly N * len(dataloader) updates
        n = self._epoch_len()
        if n is not None and self._epoch_count >= n:
            self.state.epoch += 1
            self._iterator = None
            self._epoch_count = 0
        return batch

    def _epoch_len(self) -> Optional[int]:
        try:
            return len(self.dataloader)
        except TypeError:
            return None

    def _set_epoch(self) -> None:
        sampler = getattr(self.dataloader, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(self.state.epoch)

    def update(self) -> None:
        tic = time.time()
        batch = self.read_batch()
        self.last_reader_cost = time.time() - tic
        self.update_core(batch)
        self.state.iteration += 1

    def update_core(self, batch) -> None:
        self.train_state, metrics = self.step_fn(self.train_state, batch)
        self.last_metrics = metrics
        for name, value in metrics.items():
            report(self.reports_prefix + name, value)
