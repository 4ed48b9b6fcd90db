"""What the recipes' CLIs share: the acoustic models' common flags, the
line count of an id map, the run of a ``Trainer`` with an evaluator and
snapshots (every epoch, or at the intervals the caller gives) under the
bitwise-resume setting, and the preprocessing CLIs' worker pool and
metadata splits."""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..training import (StandardUpdater, Trainer, deterministic_training,
                        to_device_batch)
from ..training.extensions import Snapshot, StandardEvaluator
from ..data.datatable import write_jsonl
from ..utils.device import add_device_arg

__all__ = ["count_lines", "add_recipe_args", "run_trainer", "run_jobs",
           "add_split_args", "write_splits"]


def count_lines(path) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


def add_recipe_args(parser) -> None:
    """--config, --train-metadata, --dev-metadata, --output-dir,
    --phones-dict (required), --opts and --device."""
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--train-metadata", type=Path, required=True)
    parser.add_argument("--dev-metadata", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exp"))
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--opts", nargs="*", default=[],
                        help="KEY VALUE pairs overriding the config")
    add_device_arg(parser)


def run_trainer(cfg, train_step, eval_step, state, train_dl, dev_dl,
                device, output_dir, *, stop=None, eval_trigger=(1, "epoch"),
                save_trigger=(1, "epoch"), log_interval: int = 1
                ) -> Trainer:
    """Train until ``stop`` (default ``cfg.max_epoch`` epochs), with the
    evaluator on ``dev_dl`` at ``eval_trigger`` and a snapshot
    (``num_snapshots`` kept) at ``save_trigger``, every epoch by default,
    resuming from the newest snapshot in ``output_dir``; returns the
    finished ``Trainer``.

    A resumed run equals a straight one bit for bit only under
    ``deterministic_training`` (deterministic algorithms, cuDNN off;
    ``tools/fs2_step_determinism.py``, ``tools/family_step_determinism.py``).
    """

    def step(st, batch):
        return train_step(st, to_device_batch(batch, device))

    def evaluate(st, batch):
        return eval_step(st, to_device_batch(batch, device))

    trainer = Trainer(StandardUpdater(step, state, train_dl),
                      stop or (cfg.max_epoch, "epoch"), out=output_dir,
                      log_interval=log_interval, config=cfg)
    trainer.extend(StandardEvaluator(evaluate, dev_dl), trigger=eval_trigger)
    trainer.extend(Snapshot(max_size=cfg.get("num_snapshots", 5)),
                   trigger=save_trigger, priority=-100)
    with deterministic_training():
        trainer.run()
    return trainer


def run_jobs(fn, jobs, num_cpu: int, *extra):
    """``fn(*job, *extra)`` for every job, in order: in ``num_cpu`` worker
    processes when it is above 1 (spawned, not forked: the parent has
    torch's threads), else in this one."""
    if num_cpu > 1:
        with ProcessPoolExecutor(num_cpu, mp_context=multiprocessing
                                 .get_context("spawn")) as ex:
            futures = [ex.submit(fn, *j, *extra) for j in jobs]
            return [f.result() for f in futures]
    return [fn(*j, *extra) for j in jobs]


def write_splits(dumpdir: Path, records, dev_size: int,
                 test_size: int) -> None:
    """The first ``dev_size`` rows to metadata_dev.jsonl, the next
    ``test_size`` to metadata_test.jsonl, the rest to
    metadata_train.jsonl; prints the count."""
    write_jsonl(dumpdir / "metadata_dev.jsonl", records[:dev_size])
    write_jsonl(dumpdir / "metadata_test.jsonl",
                records[dev_size:dev_size + test_size])
    write_jsonl(dumpdir / "metadata_train.jsonl",
                records[dev_size + test_size:])
    print(f"wrote {len(records)} utterances to {dumpdir}")


def add_split_args(parser) -> None:
    """--num-cpu, --dev-size and --test-size, with the JAX CLIs'
    defaults."""
    parser.add_argument("--num-cpu", type=int, default=1)
    parser.add_argument("--dev-size", type=int, default=100)
    parser.add_argument("--test-size", type=int, default=100)
