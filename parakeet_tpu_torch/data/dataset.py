"""Dataset combinators.

Equivalents of the reference's Chainer-style dataset algebra (reference:
parakeet/data/dataset.py:30-240): split, transform, cache, tuple/dict zip,
slice, subset, filter, chain.  Any object with ``__getitem__``/``__len__``
qualifies as a dataset.

The port's copy of ``parakeet_tpu/data/dataset.py`` (pure Python).
"""
from __future__ import annotations

from typing import Callable, Sequence

__all__ = [
    "split", "TransformDataset", "CacheDataset", "TupleDataset",
    "DictDataset", "SliceDataset", "SubsetDataset", "FilterDataset",
    "ChainDataset",
]


def split(dataset, first_size: int):
    """Split into (first ``first_size`` items, the rest)."""
    if not 0 < first_size < len(dataset):
        raise ValueError(
            f"first_size must be in (0, {len(dataset)}), got {first_size}")
    return (SliceDataset(dataset, 0, first_size),
            SliceDataset(dataset, first_size, len(dataset)))


class TransformDataset:
    """Apply ``transform`` to each example lazily."""

    def __init__(self, dataset, transform: Callable):
        self._dataset = dataset
        self._transform = transform

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        return self._transform(self._dataset[i])


class CacheDataset:
    """Memoize examples on first access."""

    def __init__(self, dataset):
        self._dataset = dataset
        self._cache: dict = {}

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = self._dataset[i]
        return self._cache[i]


class TupleDataset:
    """Zip several datasets; example i is (d1[i], d2[i], ...)."""

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("at least one dataset is required")
        self._datasets = datasets
        self._length = len(datasets[0])
        for i, d in enumerate(datasets):
            if len(d) != self._length:
                raise ValueError(
                    f"dataset {i} has length {len(d)} != {self._length}")

    def __len__(self):
        return self._length

    def __getitem__(self, i):
        return tuple(d[i] for d in self._datasets)


class DictDataset:
    """Zip named datasets; example i is {name: d[i]}."""

    def __init__(self, **datasets):
        if not datasets:
            raise ValueError("at least one dataset is required")
        lengths = {k: len(v) for k, v in datasets.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"inconsistent dataset lengths: {lengths}")
        self._datasets = datasets
        self._length = next(iter(lengths.values()))

    def __len__(self):
        return self._length

    def __getitem__(self, i):
        return {k: v[i] for k, v in self._datasets.items()}


class SliceDataset:
    """View of dataset[start:finish]."""

    def __init__(self, dataset, start: int, finish: int):
        if not 0 <= start < finish <= len(dataset):
            raise IndexError(
                f"invalid slice [{start}, {finish}) of {len(dataset)}")
        self._dataset = dataset
        self._start = start
        self._finish = finish

    def __len__(self):
        return self._finish - self._start

    def __getitem__(self, i):
        if i >= len(self) or i < -len(self):
            raise IndexError(f"index {i} out of range [0, {len(self)})")
        return self._dataset[self._start + (i % len(self))]


class SubsetDataset:
    """View selected ``indices`` of a dataset."""

    def __init__(self, dataset, indices: Sequence[int]):
        if len(indices) > len(dataset):
            raise ValueError("more indices than examples")
        self._dataset = dataset
        self._indices = list(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[self._indices[i]]


class FilterDataset:
    """Keep examples for which ``predicate(example)`` is True (eager scan)."""

    def __init__(self, dataset, predicate: Callable):
        self._dataset = dataset
        self._indices = [
            i for i in range(len(dataset)) if predicate(dataset[i])
        ]

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[self._indices[i]]


class ChainDataset:
    """Concatenate datasets end to end."""

    def __init__(self, *datasets):
        self._datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self._datasets)

    def __getitem__(self, i):
        if i < 0:
            raise IndexError("negative indices not supported")
        for d in self._datasets:
            if i < len(d):
                return d[i]
            i -= len(d)
        raise IndexError("dataset index out of range")
