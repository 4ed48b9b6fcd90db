"""Train state (counterpart of ``parakeet_tpu/training/state.py``).

The JAX package keeps every piece of mutable training state in one
immutable pytree that a jitted step maps to the next.  In PyTorch the
modules and optimizers update in place, so the state is a plain container
that a step mutates and returns: the step count, the modules (their
parameters are the params), their optimizers, and the ``torch.Generator``
that every random draw of a step takes (the JAX ``rng`` key).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    """step + modules + optimizers + random generator.

    ``modules`` / ``optimizers`` may hold several networks (e.g.
    {"generator": ..., "discriminator": ...} for GAN training).
    """
    step: int
    modules: Dict[str, nn.Module]
    optimizers: Dict[str, Any]
    rng: Optional[torch.Generator] = None
