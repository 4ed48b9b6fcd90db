"""Tacotron2 training, evaluation and prediction steps (counterpart of
``parakeet_tpu/models/tacotron2_updater.py``; reference:
examples/tacotron2/train.py and examples/tacotron2_aishell3/
train.py:36-120).

The train step updates the state's module and optimizer in place: the
teacher-forced forward with dropout on (its masks drawn from the state's
generator) and BatchNorm on batch statistics, ``tacotron2_loss``,
backward and ``optimizer.step()``.  The prenet's dropout is always on, so
evaluation and prediction draw its masks too, from a generator seeded
afresh (0) on every call: the same state and batch give the same loss.
The loss options are the recipe's ``updater`` keys:
``use_stop_token_loss``, ``use_guided_attention_loss`` and ``sigma``.
"""
from __future__ import annotations

import torch

from ..training.state import TrainState
from .tacotron2 import tacotron2_loss

__all__ = ["init_tacotron2_train_state", "make_tacotron2_train_step",
           "make_tacotron2_eval_step", "make_tacotron2_predict_step"]

EVAL_SEED = 0


def init_tacotron2_train_state(model, optimizer,
                               rng: torch.Generator) -> TrainState:
    """The model's parameters and BatchNorm statistics are its own (built
    and loaded by the caller); ``rng`` draws every dropout mask."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def _forward(model, batch, *, deterministic, rng):
    return model(batch["text"], batch["text_lengths"], batch["speech"],
                 batch["speech_lengths"], tones=batch.get("tones"),
                 global_condition=batch.get("spk_emb"),
                 deterministic=deterministic, rng=rng)


def _eval_rng(batch) -> torch.Generator:
    return torch.Generator(device=batch["speech"].device).manual_seed(
        EVAL_SEED)


def make_tacotron2_train_step(model, optimizer, *,
                              use_stop_token_loss: bool = True,
                              use_guided_attention_loss: bool = False,
                              sigma: float = 0.2):
    """``(TrainState, batch) -> (TrainState, metrics)``; metrics are
    detached 0-d tensors: the losses of ``tacotron2_loss`` and
    batch_size."""
    loss_kw = dict(use_stop_token_loss=use_stop_token_loss,
                   use_guided_attention_loss=use_guided_attention_loss,
                   sigma=sigma)

    def train_step(state: TrainState, batch):
        outputs = _forward(model, batch, deterministic=False, rng=state.rng)
        losses = tacotron2_loss(outputs, batch["speech"],
                                batch["speech_lengths"],
                                batch["text_lengths"], **loss_kw)
        optimizer.zero_grad()
        losses["loss"].backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["batch_size"] = torch.tensor(float(batch["text"].shape[0]))
        return state, metrics

    return train_step


def make_tacotron2_eval_step(model, *, use_stop_token_loss: bool = True,
                             use_guided_attention_loss: bool = False,
                             sigma: float = 0.2):
    """Loss-only evaluation step: deterministic but for the prenet, whose
    masks come from a generator seeded with ``EVAL_SEED``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        outputs = _forward(model, batch, deterministic=True,
                           rng=_eval_rng(batch))
        return tacotron2_loss(
            outputs, batch["speech"], batch["speech_lengths"],
            batch["text_lengths"], use_stop_token_loss=use_stop_token_loss,
            use_guided_attention_loss=use_guided_attention_loss, sigma=sigma)

    return eval_step


def make_tacotron2_predict_step(model):
    """The teacher-forced forward's outputs (alignments, mels) of the
    evaluation step, for figures."""

    @torch.no_grad()
    def predict_step(state: TrainState, batch):
        return _forward(model, batch, deterministic=True,
                        rng=_eval_rng(batch))

    return predict_step
