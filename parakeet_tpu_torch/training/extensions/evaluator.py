"""Evaluation extension (counterpart of
``parakeet_tpu/training/extensions/evaluator.py``).

Same role as the reference's StandardEvaluator (reference:
parakeet/training/extensions/evaluator.py:26-78): iterate the dev loader
with an eval function that computes no gradient, average the reported
metrics and report the means into the trainer's observation.
"""
from __future__ import annotations

from typing import Callable

from ..extension import PRIORITY_WRITER, Extension
from ..reporter import DictSummary, report, scope

__all__ = ["StandardEvaluator"]


class StandardEvaluator(Extension):
    trigger = (1, "epoch")
    priority = PRIORITY_WRITER
    default_name = "validation"

    def __init__(self, eval_fn: Callable, dataloader,
                 prefix: str = "eval/"):
        """``eval_fn(train_state, batch) -> metrics dict``."""
        self.eval_fn = eval_fn
        self.dataloader = dataloader
        self.prefix = prefix

    def evaluate(self, trainer) -> dict:
        summary = DictSummary()
        state = trainer.updater.train_state
        for batch in self.dataloader:
            observation = {}
            with scope(observation):
                metrics = self.eval_fn(state, batch)
                for name, value in metrics.items():
                    report(self.prefix + name, value)
            summary.add(observation)
        return summary.compute_mean()

    def __call__(self, trainer) -> None:
        for name, value in self.evaluate(trainer).items():
            report(name, value)
