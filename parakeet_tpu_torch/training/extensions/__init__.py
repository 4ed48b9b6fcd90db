"""Trainer extensions of the port (counterpart of
``parakeet_tpu.training.extensions``): the evaluator and snapshots.  Not
ported: the TensorBoard writer and the visualizer (ROADMAP queue 1 item
8)."""
from .evaluator import StandardEvaluator
from .snapshot import Snapshot

__all__ = ["StandardEvaluator", "Snapshot"]
