"""Deterministic seeding (counterpart of
``parakeet_tpu/training/seeding.py``).

Python's, numpy's and torch's global generators are seeded in place; the
returned ``torch.Generator`` is the root of all randomness a training step
draws (noise), as the JAX version returns the root ``jax.random`` key.
The JAX package's ``configure_rng_impl`` (the TPU's rbg knob) is not
ported.  ``deterministic_training`` is the setting the recipes train
under so that a resumed run equals a straight one bit for bit.
"""
from __future__ import annotations

import contextlib
import logging
import random

import numpy as np
import torch

__all__ = ["seed_everything", "deterministic_training"]


def seed_everything(seed: int, device="cuda") -> torch.Generator:
    """Seed python, numpy and torch; return a generator on ``device``
    (the card unless the caller asks for the CPU)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logging.getLogger(__name__).debug("Set the seed of python/numpy/torch "
                                      "to %d", seed)
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def deterministic_training():
    """PyTorch's deterministic algorithms (warning, not raising, where an
    op has none) with cuDNN off, given back as they were on exit.

    A resumed run equals a straight one only if a step's sums do not
    change from run to run.  On the card two things change them
    (``tools/fs2_step_determinism.py``): the default backwards of gathers
    (the length regulator's), embeddings and cuDNN's convolutions add in
    a run-dependent order, and cuDNN's heuristics pick a convolution's
    plan by the largest block the caching allocator holds free, so that
    a step depends on the allocator's history.  With cuDNN off the
    convolutions, batch norms and LSTMs run PyTorch's native kernels.
    """
    previous = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.enabled)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous[0],
                                           warn_only=previous[1])
        torch.backends.cudnn.enabled = previous[2]
