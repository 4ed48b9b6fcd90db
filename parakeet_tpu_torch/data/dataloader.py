"""Batch sampling and a prefetching loader (counterpart of
``parakeet_tpu/data/dataloader.py``'s ``BatchSampler`` and ``DataLoader``).

``BatchSampler`` shuffles with a generator seeded from (seed + epoch), so
an epoch's order depends on its number only, and drops a last partial
batch unless ``drop_last=False`` (the FastSpeech2 recipe's dev set keeps
it); ``set_epoch`` is the reference's
DistributedBatchSampler.set_epoch (standard_updater.py:162-168), called by
the updater when an epoch starts.  ``DataLoader`` maps a collate function
over the sampled batches on a background thread, PREFETCH batches ahead,
so host work overlaps the card's.  At the start of every pass it hands the
sampler's epoch to a collate function that has ``set_epoch`` (the random
clip of ``collate.VocoderClip``), so a pass draws the same examples and the
same random crops whether or not the run was resumed in between.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np

__all__ = ["BatchSampler", "DataLoader"]

PREFETCH = 2


class BatchSampler:
    """Yields lists of ``batch_size`` indices, shuffled or in order, and
    with ``drop_last=False`` a last, shorter list of the rest."""

    def __init__(self, dataset_size: int, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[List[int]]:
        idx = self._indices()
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            yield idx[s:s + self.batch_size].tolist()

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_size // self.batch_size
        return -(-self.dataset_size // self.batch_size)


class DataLoader:
    """Iterates ``collate_fn([dataset[i] for i in batch])``, collated on a
    thread feeding a bounded queue.  A pass that is left early (the
    generator closed or dropped) stops its thread before returning."""

    def __init__(self, dataset, batch_sampler: BatchSampler,
                 collate_fn: Callable):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn

    def _produce(self, out_q: "queue.Queue", batches: Sequence[List[int]],
                 stop: threading.Event) -> None:
        try:
            for batch_idx in batches:
                if stop.is_set():
                    return
                examples = [self.dataset[i] for i in batch_idx]
                out_q.put(("item", self.collate_fn(examples)))
        except Exception as e:  # handed to the consumer, which raises it
            out_q.put(("error", e))
        else:
            out_q.put(("done", None))

    def __iter__(self):
        set_epoch = getattr(self.collate_fn, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self.batch_sampler.epoch)
        batches = list(self.batch_sampler)
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce,
                                  args=(out_q, batches, stop), daemon=True)
        worker.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "item":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            stop.set()
            while worker.is_alive():    # unblock a put on a full queue
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            worker.join()

    def __len__(self) -> int:
        return len(self.batch_sampler)
