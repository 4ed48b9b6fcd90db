"""Deterministic seeding (counterpart of
``parakeet_tpu/training/seeding.py``).

Python's, numpy's and torch's global generators are seeded in place; the
returned ``torch.Generator`` is the root of all randomness a training step
draws (noise), as the JAX version returns the root ``jax.random`` key.
The JAX package's ``configure_rng_impl`` (the TPU's rbg knob) is not
ported.
"""
from __future__ import annotations

import logging
import random

import numpy as np
import torch

__all__ = ["seed_everything"]


def seed_everything(seed: int, device="cpu") -> torch.Generator:
    """Seed python, numpy and torch; return a generator on ``device``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logging.getLogger(__name__).debug("Set the seed of python/numpy/torch "
                                      "to %d", seed)
    return torch.Generator(device=device).manual_seed(seed)
