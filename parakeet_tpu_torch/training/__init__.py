"""Training runtime of the port (counterpart of ``parakeet_tpu.training``):
trainer, updaters, extensions, optimizers, state, seeding.  Not ported
yet: checkpoints and snapshots, the evaluator and visualizer extensions,
and the YAML config."""
from .extension import (PRIORITY_EDITOR, PRIORITY_READER, PRIORITY_WRITER,
                        Extension, make_extension)
from .optimizer import (Optimizer, build_optimizer, constant_schedule,
                        piecewise_schedule, step_decay_schedule)
from .reporter import DictSummary, Summary, report, scope
from .seeding import seed_everything
from .state import TrainState
from .trainer import Trainer
from .triggers import (IntervalTrigger, LimitTrigger, TimeTrigger,
                       get_trigger)
from .updater import StandardUpdater, UpdaterBase, UpdaterState

__all__ = [
    "Trainer", "StandardUpdater", "UpdaterBase", "UpdaterState",
    "TrainState",
    "Extension", "make_extension", "PRIORITY_WRITER", "PRIORITY_EDITOR",
    "PRIORITY_READER",
    "IntervalTrigger", "LimitTrigger", "TimeTrigger", "get_trigger",
    "report", "scope", "Summary", "DictSummary",
    "Optimizer", "build_optimizer", "step_decay_schedule",
    "piecewise_schedule", "constant_schedule",
    "seed_everything",
]
