"""What the acoustic-model recipes' CLIs share: their common flags, the
line count of an id map, and the run of a ``Trainer`` with an evaluator
and a snapshot every epoch under the bitwise-resume setting."""
from __future__ import annotations

from pathlib import Path

from ..training import (StandardUpdater, Trainer, deterministic_training,
                        to_device_batch)
from ..training.extensions import Snapshot, StandardEvaluator
from ..utils.device import add_device_arg

__all__ = ["count_lines", "add_recipe_args", "run_trainer"]


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
                device, output_dir) -> Trainer:
    """Train ``cfg.max_epoch`` epochs, with the evaluator on ``dev_dl``
    and a snapshot (``num_snapshots`` kept) every epoch, resuming from
    the newest snapshot in ``output_dir``; returns the finished
    ``Trainer``.

    A resumed run equals a straight one bit for bit only under
    ``deterministic_training`` (deterministic algorithms, cuDNN off;
    ``tools/fs2_step_determinism.py``, ``tools/family_step_determinism.py``).
    """

    def step(st, batch):
        return train_step(st, to_device_batch(batch, device))

    def evaluate(st, batch):
        return eval_step(st, to_device_batch(batch, device))

    trainer = Trainer(StandardUpdater(step, state, train_dl),
                      (cfg.max_epoch, "epoch"), out=output_dir, config=cfg)
    trainer.extend(StandardEvaluator(evaluate, dev_dl), trigger=(1, "epoch"))
    trainer.extend(Snapshot(max_size=cfg.get("num_snapshots", 5)),
                   trigger=(1, "epoch"), priority=-100)
    with deterministic_training():
        trainer.run()
    return trainer
