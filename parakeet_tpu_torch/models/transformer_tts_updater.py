"""TransformerTTS training, evaluation and prediction steps (counterpart of
``parakeet_tpu/models/transformer_tts_updater.py``; reference:
parakeet/models/transformer_tts/transformer_tts_updater.py:31-322).

The train step updates the state's module and optimizer in place: the
teacher-forced forward with dropout on (its masks drawn from the state's
generator) and BatchNorm on batch statistics, ``transformer_tts_loss``
(L1 and/or L2 and the stop BCE), the guided multi-head attention loss on
the decoder's cross-attention stack when asked, backward and
``optimizer.step()``.  The decoder prenet's dropout is always on, so
evaluation and prediction draw its masks too, from a generator seeded
afresh (``EVAL_SEED``) on every call: the same state and batch give the
same loss.  The options are the recipe's ``updater`` keys.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..training.state import TrainState
from .transformer_tts import (guided_multihead_attention_loss,
                              transformer_tts_loss)

__all__ = ["init_transformer_tts_train_state",
           "make_transformer_tts_train_step",
           "make_transformer_tts_eval_step",
           "make_transformer_tts_predict_step"]

EVAL_SEED = 0


def init_transformer_tts_train_state(model, optimizer,
                                     rng: torch.Generator) -> TrainState:
    """The model's parameters and BatchNorm statistics are its own (built
    and loaded by the caller); ``rng`` draws every dropout mask."""
    return TrainState(step=0, modules={"model": model},
                      optimizers={"model": optimizer}, rng=rng)


def _forward(model, batch, *, deterministic, rng):
    return model(batch["text"], batch["text_lengths"], batch["speech"],
                 batch["speech_lengths"], spk_emb=batch.get("spk_emb"),
                 deterministic=deterministic, rng=rng)


def _eval_rng(batch) -> torch.Generator:
    return torch.Generator(device=batch["speech"].device).manual_seed(
        EVAL_SEED)


def _loss_fn(model, *, loss_type: str = "L1", bce_pos_weight: float = 5.0,
             use_guided_attn_loss: bool = True,
             guided_attn_sigma: float = 0.4, guided_attn_lambda: float = 1.0,
             num_layers_applied_guided_attn: Optional[int] = 2,
             num_heads_applied_guided_attn: Optional[int] = 2):
    """``(outputs, batch) -> losses`` with the recipe's ``updater`` keys:
    ``transformer_tts_loss``, and with ``use_guided_attn_loss`` the guided
    loss of the cross-attention stack (``guided_attn_loss``, added to the
    loss times ``guided_attn_lambda``; the encoder's lengths count the
    ``<eos>`` the model appends)."""

    def losses_of(outputs, batch):
        losses = transformer_tts_loss(outputs, batch["speech"],
                                      batch["speech_lengths"],
                                      loss_type=loss_type,
                                      bce_pos_weight=bce_pos_weight)
        if use_guided_attn_loss:
            r = model.reduction_factor
            ga = guided_multihead_attention_loss(
                outputs["dec_cross_attns"],
                torch.div(batch["speech_lengths"], r, rounding_mode="floor"),
                batch["text_lengths"] + 1, sigma=guided_attn_sigma,
                num_layers=num_layers_applied_guided_attn,
                num_heads=num_heads_applied_guided_attn)
            losses["guided_attn_loss"] = ga
            losses["loss"] = losses["loss"] + guided_attn_lambda * ga
        return losses

    return losses_of


def make_transformer_tts_train_step(model, optimizer, **updater):
    """``(TrainState, batch) -> (TrainState, metrics)``; metrics are
    detached 0-d tensors: the losses and batch_size.  ``updater``: the
    recipe's ``updater`` keys (see ``_loss_fn``)."""
    losses_of = _loss_fn(model, **updater)

    def train_step(state: TrainState, batch):
        outputs = _forward(model, batch, deterministic=False, rng=state.rng)
        losses = losses_of(outputs, batch)
        optimizer.zero_grad()
        losses["loss"].backward()
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["batch_size"] = torch.tensor(float(batch["text"].shape[0]))
        return state, metrics

    return train_step


def make_transformer_tts_eval_step(model, **updater):
    """Loss-only evaluation step: deterministic but for the decoder
    prenet, whose masks come from a generator seeded with ``EVAL_SEED``."""
    losses_of = _loss_fn(model, **updater)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        return losses_of(_forward(model, batch, deterministic=True,
                                  rng=_eval_rng(batch)), batch)

    return eval_step


def make_transformer_tts_predict_step(model):
    """The evaluation step's teacher-forced outputs (attention stacks,
    mels), for figures."""

    @torch.no_grad()
    def predict_step(state: TrainState, batch):
        return _forward(model, batch, deterministic=True,
                        rng=_eval_rng(batch))

    return predict_step
