"""Optimizer and LR-schedule factories (counterpart of
``parakeet_tpu/training/optimizer.py``) on ``torch.optim``.

The JAX package builds optax chains; here ``build_optimizer`` wraps a
``torch.optim`` optimizer with what the chain adds: global-norm clipping
of the raw gradients first (``max_grad_norm``), then weight decay, then
the update, with the learning rate from a schedule through ``LambdaLR``.
Weight decay is decoupled for 'adamw' (as ``optax.adamw``) and added to
the gradient for the others (as ``optax.add_decayed_weights`` before the
optimizer, which is what ``torch.optim``'s ``weight_decay`` does).
Defaults follow optax where ``torch.optim``'s differ.  A schedule maps the
number of updates made so far to the learning rate, as optax's does.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import torch

__all__ = ["Optimizer", "build_optimizer", "step_decay_schedule",
           "piecewise_schedule", "constant_schedule"]

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def step_decay_schedule(learning_rate: float, step_size: int,
                        gamma: float = 0.5) -> Schedule:
    """lr * gamma^(step // step_size) -- paddle StepDecay semantics."""
    return lambda count: learning_rate * gamma ** (count // step_size)


def piecewise_schedule(boundaries: Sequence[int],
                       values: Sequence[float]) -> Schedule:
    """values[i] for step in [boundaries[i-1], boundaries[i])."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")

    def schedule(count):
        lr = values[0]
        for b, v in zip(boundaries, values[1:]):
            if count >= b:
                lr = v
        return lr
    return schedule


def _betas(kw):
    if "b1" in kw or "b2" in kw:
        kw["betas"] = (kw.pop("b1", 0.9), kw.pop("b2", 0.999))
    return kw


# name -> (torch class, optax's defaults where torch's differ)
_OPTIMIZERS = {
    "adadelta": (torch.optim.Adadelta, dict(rho=0.9, eps=1e-6)),
    "adagrad": (torch.optim.Adagrad,
                dict(initial_accumulator_value=0.1, eps=1e-7)),
    "adam": (torch.optim.Adam, {}),
    "adamw": (torch.optim.AdamW, dict(weight_decay=1e-4)),
    "adamax": (torch.optim.Adamax, {}),
    "momentum": (torch.optim.SGD, dict(momentum=0.9)),
    "rmsprop": (torch.optim.RMSprop, dict(alpha=0.9, eps=1e-8)),
    "sgd": (torch.optim.SGD, {}),
}


class Optimizer:
    """A ``torch.optim`` optimizer with its schedule and clipping.

    ``step()`` clips the gradients' global norm, updates the parameters
    and advances the schedule, as one optax update does.
    """

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 inner: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LambdaLR,
                 max_grad_norm: Optional[float]):
        self.params = list(params)
        self.inner = inner
        self.scheduler = scheduler
        self.max_grad_norm = max_grad_norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.max_grad_norm:
            torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm)
        self.inner.step()
        self.scheduler.step()


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optim: str = "adam",
                    learning_rate: Union[float, Schedule] = 0.001,
                    max_grad_norm: Optional[float] = None,
                    weight_decay: Optional[float] = None,
                    **kwargs) -> Optimizer:
    """Name -> ``Optimizer`` over ``params``, with optional global-norm
    clipping.  ``learning_rate`` may be a float or a schedule (count ->
    lr).  optax's ``b1``/``b2`` keywords become torch's ``betas``.
    'lamb' has no ``torch.optim`` counterpart and is not ported."""
    name = optim.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {optim!r}; available: {sorted(_OPTIMIZERS)}")
    cls, defaults = _OPTIMIZERS[name]
    kw = {**defaults, **_betas(dict(kwargs))}
    if weight_decay:
        kw["weight_decay"] = weight_decay
    params = [p for p in params if p.requires_grad]
    schedule = (learning_rate if callable(learning_rate)
                else constant_schedule(learning_rate))
    # base lr 1: LambdaLR's factor is then the schedule's learning rate
    inner = cls(params, lr=1.0, **kw)
    scheduler = torch.optim.lr_scheduler.LambdaLR(inner, schedule)
    return Optimizer(params, inner, scheduler, max_grad_norm)
