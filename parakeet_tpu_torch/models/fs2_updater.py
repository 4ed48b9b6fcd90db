"""FastSpeech2 training and evaluation steps (counterpart of
``parakeet_tpu/models/fs2_updater.py``).

The JAX step is one jitted program that maps the state to the next; here
the step updates the state's module and optimizer in place: forward (not
deterministic: dropout on, the Postnet's BatchNorm on batch statistics),
``fastspeech2_loss``, backward and ``optimizer.step()``.  The BatchNorm
running statistics live in the module's buffers (the JAX state's
``batch_stats``) and the forward updates them; every dropout mask is drawn
from the state's generator (the JAX state's ``rng``).
"""
from __future__ import annotations

import torch

from ..training.state import TrainState
from .fastspeech2 import fastspeech2_loss

__all__ = ["make_fs2_train_step", "make_fs2_eval_step",
           "init_fs2_train_state"]

_BATCH_KEYS = ("text", "text_lengths", "speech", "speech_lengths",
               "durations", "pitch", "energy")


def init_fs2_train_state(model, optimizer, rng: torch.Generator
                         ) -> TrainState:
    """The model's parameters and BatchNorm statistics are its own (the
    JAX ``init`` draws them; here the module was built and loaded)."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def _forward(model, batch, *, deterministic, rng):
    return model(*[batch[k] for k in _BATCH_KEYS],
                 spk_id=batch.get("spk_id"), spk_emb=batch.get("spk_emb"),
                 deterministic=deterministic, rng=rng)


def make_fs2_train_step(model, optimizer, *, use_masking: bool = True,
                        use_weighted_masking: bool = False):
    """Build ``(TrainState, batch) -> (TrainState, metrics)``; metrics are
    detached 0-d tensors: loss, l1_loss, duration_loss, pitch_loss,
    energy_loss and batch_size."""

    def train_step(state: TrainState, batch):
        outputs = _forward(model, batch, deterministic=False, rng=state.rng)
        losses = fastspeech2_loss(outputs, batch, use_masking,
                                  use_weighted_masking)
        optimizer.zero_grad()
        losses["loss"].backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["batch_size"] = torch.tensor(float(batch["text"].shape[0]))
        return state, metrics

    return train_step


def make_fs2_eval_step(model, *, use_masking: bool = True,
                       use_weighted_masking: bool = False):
    """Loss-only evaluation step: deterministic (no dropout, BatchNorm's
    running statistics), no gradient."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        outputs = _forward(model, batch, deterministic=True, rng=None)
        return fastspeech2_loss(outputs, batch, use_masking,
                                use_weighted_masking)

    return eval_step
