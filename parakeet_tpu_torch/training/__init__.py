"""Training runtime of the port (counterpart of ``parakeet_tpu.training``):
trainer, updaters, extensions (evaluator, snapshots), optimizers, state,
seeding, checkpoints in the JAX package's npz format and the YAML config.
Not ported yet: the TensorBoard writer and the visualizer."""
from .checkpoint import SnapshotRing, load_pytree, save_pytree
from .config import Config, inference_model_kwargs, resolve_model_kwargs
from .extension import (PRIORITY_EDITOR, PRIORITY_READER, PRIORITY_WRITER,
                        Extension, make_extension)
from .optimizer import (Optimizer, build_optimizer, constant_schedule,
                        piecewise_schedule, step_decay_schedule)
from .reporter import DictSummary, Summary, report, scope
from .seeding import deterministic_training, seed_everything
from .state import TrainState
from .trainer import Trainer
from .triggers import (IntervalTrigger, LimitTrigger, TimeTrigger,
                       get_trigger)
from .updater import (StandardUpdater, UpdaterBase, UpdaterState,
                      to_device_batch)

__all__ = [
    "Trainer", "StandardUpdater", "UpdaterBase", "UpdaterState",
    "TrainState",
    "Extension", "make_extension", "PRIORITY_WRITER", "PRIORITY_EDITOR",
    "PRIORITY_READER",
    "IntervalTrigger", "LimitTrigger", "TimeTrigger", "get_trigger",
    "report", "scope", "Summary", "DictSummary",
    "Optimizer", "build_optimizer", "step_decay_schedule",
    "piecewise_schedule", "constant_schedule",
    "seed_everything", "deterministic_training", "to_device_batch",
    "Config", "resolve_model_kwargs", "inference_model_kwargs",
    "save_pytree", "load_pytree", "SnapshotRing",
]
