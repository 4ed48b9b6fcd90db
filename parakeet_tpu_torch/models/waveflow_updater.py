"""WaveFlow training and evaluation steps (counterpart of
``parakeet_tpu/models/waveflow_updater.py``; reference:
examples/waveflow/train.py:18-115).

The train step updates the state's module and optimizer in place: the
density forward on a (wav, mel) batch, ``waveflow_loss`` at the model's
``sigma``, backward and ``optimizer.step()``.  WaveFlow draws nothing, so
the state's generator is only carried.
"""
from __future__ import annotations

import torch

from ..training.state import TrainState
from .waveflow import waveflow_loss

__all__ = ["init_waveflow_train_state", "make_waveflow_train_step",
           "make_waveflow_eval_step"]


def init_waveflow_train_state(model, optimizer,
                              rng: torch.Generator) -> TrainState:
    """The model's parameters are its own (built and loaded by the
    caller)."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def make_waveflow_train_step(model, optimizer, *, sigma: float = 1.0):
    """``(TrainState, batch) -> (TrainState, metrics)``; metrics are
    detached 0-d tensors: loss, nll, logdet and batch_size."""

    def train_step(state: TrainState, batch):
        losses = waveflow_loss(*model(batch["wav"], batch["mel"]), sigma)
        optimizer.zero_grad()
        losses["loss"].backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["batch_size"] = torch.tensor(float(batch["wav"].shape[0]))
        return state, metrics

    return train_step


def make_waveflow_eval_step(model, *, sigma: float = 1.0):
    """The loss of the density forward, without gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        return waveflow_loss(*model(batch["wav"], batch["mel"]), sigma)

    return eval_step
