"""GE2E speaker-encoder training step (counterpart of
``parakeet_tpu/models/ge2e_updater.py``; reference: examples/ge2e/
train.py:19-80).

The step updates the state's module and optimizer in place: embed the
(N x M) utterance batch, the GE2E loss, backward, scale the similarity
scale's (w, b) gradients by ``wb_grad_scale`` (``do_gradient_ops``), then
the optimizer's update.  As in the JAX step there is no global-norm clip
(the JAX module's docstring names one; neither its step nor its recipe
applies it).  The step draws nothing random.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..training.state import TrainState
from .lstm_speaker_encoder import ge2e_loss, scale_wb_gradients

__all__ = ["init_ge2e_train_state", "make_ge2e_train_step"]


def init_ge2e_train_state(model, optimizer,
                          rng: Optional[torch.Generator] = None
                          ) -> TrainState:
    """The model's parameters are its own (built and loaded by the
    caller)."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def make_ge2e_train_step(model, optimizer, n_speakers: int, *,
                         wb_grad_scale: float = 0.01):
    """``(TrainState, batch) -> (TrainState, metrics)``; ``batch`` holds
    ``utterances`` (N*M, T, n_mels), the M utterances of each speaker
    together; metrics are the detached 0-d loss and accuracy."""

    def train_step(state: TrainState, batch):
        embeds, (w, b) = model.embed_sequences(batch["utterances"],
                                               n_speakers)
        loss, metrics = ge2e_loss(embeds, w, b)
        optimizer.zero_grad()
        loss.backward()
        scale_wb_gradients(model, wb_grad_scale)
        optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()
                       if k != "sim"}

    return train_step
