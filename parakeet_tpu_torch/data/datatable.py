"""Metadata-driven example table (a copy of
``parakeet_tpu/data/datatable.py``; the port imports nothing of the JAX
package).

A list-of-dicts metadata table with per-field converters (e.g. ``np.load``
for the paths of feature arrays), as the reference's DataTable
(reference: parakeet/datasets/data_table.py:23-151).  The JAX copy's
field selection and in-memory cache are not ported: the recipe uses
neither.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["DataTable", "read_jsonl", "write_jsonl"]


def read_jsonl(path) -> List[Dict[str, Any]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def write_jsonl(path, records: Sequence[Dict[str, Any]]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


class DataTable:
    """A dataset view over a list of metadata dicts (rows); ``converters``
    are per-field callables applied at access time (e.g. ``{"wave":
    np.load}``)."""

    def __init__(self, data: Sequence[Dict[str, Any]],
                 converters: Optional[Dict[str, Callable]] = None):
        if not data:
            raise ValueError("data should not be empty")
        self.data = list(data)
        self.converters = dict(converters or {})

    @classmethod
    def from_jsonl(cls, path, **kwargs) -> "DataTable":
        return cls(read_jsonl(path), **kwargs)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.data[idx]
        return {name: self.converters[name](value)
                if name in self.converters else value
                for name, value in row.items()}

    def __len__(self) -> int:
        return len(self.data)
