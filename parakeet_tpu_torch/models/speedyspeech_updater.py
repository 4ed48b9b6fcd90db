"""SpeedySpeech training and evaluation steps (counterpart of
``parakeet_tpu/models/speedyspeech_updater.py``; reference:
parakeet/models/speedyspeech/speedyspeech_updater.py:33-157).

The step updates the state's module and optimizer in place: the
teacher-forced forward (BatchNorm on batch statistics, whose running
averages it updates), ``speedyspeech_loss``, backward and
``optimizer.step()``.  The expansion's capacity is the padded length of
``feats``, the frame bucket of the batch.
"""
from __future__ import annotations

import torch

from ..training.state import TrainState
from .speedyspeech import speedyspeech_loss

__all__ = ["init_speedyspeech_train_state", "make_speedyspeech_train_step",
           "make_speedyspeech_eval_step"]


def init_speedyspeech_train_state(model, optimizer,
                                  rng: torch.Generator) -> TrainState:
    """The model's parameters and BatchNorm statistics are its own (built
    and loaded by the caller); SpeedySpeech draws nothing, but the state
    keeps the generator as every port state does."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def _forward(model, batch, *, deterministic):
    return model(batch["phones"], batch["durations"],
                 tones=batch.get("tones"), spk_id=batch.get("spk_id"),
                 max_frames=batch["feats"].shape[1],
                 deterministic=deterministic)


def make_speedyspeech_train_step(model, optimizer):
    """``(TrainState, batch) -> (TrainState, metrics)``; metrics are
    detached 0-d tensors: loss, l1_loss, ssim_loss, duration_loss and
    batch_size."""

    def train_step(state: TrainState, batch):
        losses = speedyspeech_loss(_forward(model, batch,
                                            deterministic=False), batch)
        optimizer.zero_grad()
        losses["loss"].backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["batch_size"] = torch.tensor(float(batch["phones"].shape[0]))
        return state, metrics

    return train_step


def make_speedyspeech_eval_step(model):
    """Loss-only evaluation step on BatchNorm's running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        return speedyspeech_loss(_forward(model, batch, deterministic=True),
                                 batch)

    return eval_step
