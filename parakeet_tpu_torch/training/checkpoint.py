"""Checkpoints: the JAX package's npz format and its snapshot ring
(counterpart of ``parakeet_tpu/training/checkpoint.py``).

A checkpoint is one ``.npz`` of flat ``a::b::c`` keys (the flattened
pytree of ``flatten_tree`` in the JAX package) plus a ``__metadata__``
entry holding JSON, written atomically (a temporary file, then
``os.replace``).  The two packages read each other's files:
``bridge.train_state_arrays`` / ``bridge.load_train_state`` map a port
``TrainState`` onto the JAX ``TrainState``'s keys and back.
``records.jsonl`` is the ring's ledger, newest last; ``max_size`` newest
snapshots are kept.

Only rank 0 writes: ``save_pytree`` and ``SnapshotRing.register`` touch
no file on any other rank of an initialized ``torch.distributed`` group.
The JAX ring's ``register`` writes the ledger and prunes on every process
(ROADMAP queue 3); this one does not.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["SEP", "save_pytree", "load_pytree", "nest_flat",
           "flatten_nested", "SnapshotRing",
           "latest_record", "resolve_record_path", "load_variables",
           "process_rank"]

SEP = "::"
_META = "__metadata__"


def process_rank() -> int:
    """This process's rank in the default ``torch.distributed`` group, 0
    without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def save_pytree(path, flat: Dict[str, np.ndarray],
                metadata: Optional[dict] = None) -> None:
    """Atomically write ``flat`` ({key: array}) and JSON ``metadata`` to
    ``path`` (.npz).  Only rank 0 writes."""
    if process_rank() != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    if _META in arrays:
        raise ValueError(f"{_META!r} is reserved for the metadata")
    arrays[_META] = np.frombuffer(json.dumps(metadata or {}).encode(),
                                  dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_pytree(path):
    """(flat {key: array}, metadata dict) of a checkpoint."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta_raw = flat.pop(_META, None)
    metadata = (json.loads(bytes(meta_raw.tobytes()).decode())
                if meta_raw is not None else {})
    return flat, metadata


def nest_flat(flat: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Flat {a::b::c: arr} -> nested dicts."""
    nested: Dict[str, object] = {}
    for key, value in flat.items():
        node = nested
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return nested


def flatten_nested(tree: Dict[str, object], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """Nested dicts -> flat {a::b::c: arr}, the inverse of ``nest_flat``."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_nested(value, name))
        else:
            flat[name] = value
    return flat


def resolve_record_path(record: dict, directory) -> str:
    """A record's snapshot path, resolved against ``directory`` (records
    store it relative to the ring's directory, so an experiment directory
    can be moved whole)."""
    p = Path(record["path"])
    return str(p if p.is_absolute() else Path(directory) / p)


def _read_records(directory) -> List[dict]:
    path = Path(directory) / "records.jsonl"
    if not path.exists():
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def latest_record(directory) -> Optional[dict]:
    """Newest record of ``records.jsonl`` in ``directory`` with its path
    resolved, or None."""
    records = _read_records(directory)
    if not records:
        return None
    last = dict(records[-1])
    last["path"] = resolve_record_path(last, directory)
    return last


class SnapshotRing:
    """Keeps the ``max_size`` newest snapshots and a records.jsonl ledger.

    ``rank`` (default: ``process_rank()``) gates the file system: every
    rank keeps the same records in memory, and only rank 0 writes the
    ledger and deletes pruned snapshots.
    """

    def __init__(self, directory, max_size: int = 5,
                 prefix: str = "snapshot_iter_", rank: Optional[int] = None):
        if max_size < 1:
            raise ValueError("max_size must be at least 1")
        self.directory = Path(directory)
        self.max_size = max_size
        self.prefix = prefix
        self.rank = process_rank() if rank is None else rank
        self.records: List[dict] = _read_records(self.directory)

    def path_for(self, iteration: int) -> Path:
        return self.directory / f"{self.prefix}{iteration}.npz"

    def register(self, path, iteration: int) -> None:
        """Record a written snapshot and prune the ring past ``max_size``.
        The ledger stores the path relative to the ring's directory when it
        lies inside it."""
        path = Path(path)
        try:
            stored = str(path.resolve().relative_to(
                self.directory.resolve()))
        except ValueError:
            stored = str(path)
        self.records.append({"time": time.time(), "path": stored,
                             "iteration": iteration})
        victims = []
        while len(self.records) > self.max_size:
            victims.append(self.records.pop(0))
        if self.rank != 0:
            return
        for victim in victims:
            try:
                os.unlink(resolve_record_path(victim, self.directory))
            except FileNotFoundError:
                pass
        self._write_records()

    def _write_records(self) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.directory / "records.jsonl.tmp"
        with open(tmp, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")
        os.replace(tmp, self.directory / "records.jsonl")

    def latest(self) -> Optional[dict]:
        """Newest record with its ``path`` resolved, or None."""
        if not self.records:
            return None
        rec = dict(self.records[-1])
        rec["path"] = resolve_record_path(rec, self.directory)
        return rec


def load_variables(path) -> Dict[str, object]:
    """Checkpoint -> {"params": nested arrays[, "batch_stats": ...]} of one
    network, as the JAX ``load_variables``: a GAN train state's
    ``params::generator`` is unwrapped.  ``bridge.load_flax_params`` takes
    it into a module after ``flatten_nested``."""
    flat, _ = load_pytree(path)
    tree = nest_flat(flat)
    params = tree.get("params", tree)
    if isinstance(params, dict) and "generator" in params:
        params = params["generator"]
    variables = {"params": params}
    if "batch_stats" in tree:
        variables["batch_stats"] = tree["batch_stats"]
    return variables
