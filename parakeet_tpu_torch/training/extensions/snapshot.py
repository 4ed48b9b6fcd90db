"""Snapshot extension: periodic checkpoints and auto-resume (counterpart
of ``parakeet_tpu/training/extensions/snapshot.py``).

Same behaviour as the reference's Snapshot (reference:
parakeet/training/extensions/snapshot.py:36-111): saves
``snapshot_iter_{N}.npz`` through the updater into ``<out>/checkpoints``,
keeps the ``max_size`` newest in a records.jsonl ring (written by rank 0
only), resumes from the newest record in ``initialize`` and can snapshot
on error.  The trainer primes its interval triggers after ``initialize``,
so a resumed run next fires on progress made after the snapshot.
"""
from __future__ import annotations

import logging
from pathlib import Path

from ..checkpoint import SnapshotRing
from ..extension import Extension

logger = logging.getLogger(__name__)

__all__ = ["Snapshot"]


class Snapshot(Extension):
    trigger = (1, "epoch")
    priority = -100
    default_name = "snapshot"

    def __init__(self, max_size: int = 5, snapshot_on_error: bool = False):
        self.max_size = max_size
        self._snapshot_on_error = snapshot_on_error
        self.ring = None

    def initialize(self, trainer) -> None:
        """Resume from the newest record if any."""
        self.ring = SnapshotRing(Path(trainer.out) / "checkpoints",
                                 max_size=self.max_size)
        record = self.ring.latest()
        if record is not None:
            logger.info("Loading from an existing checkpoint %s",
                        record["path"])
            trainer.updater.load(record["path"])

    def on_error(self, trainer, exc, tb) -> None:
        if self._snapshot_on_error:
            self._save(trainer)

    def __call__(self, trainer) -> None:
        self._save(trainer)

    def _save(self, trainer) -> None:
        iteration = trainer.updater.state.iteration
        path = self.ring.path_for(iteration)
        trainer.updater.save(path)
        self.ring.register(path, iteration)
