"""Feature normalization (counterpart of
``parakeet_tpu/ops/normalizer.py::ZScore``)."""
from __future__ import annotations

import torch

__all__ = ["ZScore"]


class ZScore:
    """Elementwise (x - mu) / sigma with stored (D,) statistics, broadcast
    over leading axes.  The statistics follow the input's device and
    dtype; a caller that applies it many times on one device (the serving
    engine, whose CUDA graphs may copy nothing from the host) moves them
    there once with ``to``."""

    def __init__(self, mu, sigma):
        self.mu = torch.as_tensor(mu)
        self.sigma = torch.as_tensor(sigma)

    def to(self, device) -> "ZScore":
        """The same normalizer with its statistics on ``device``."""
        return ZScore(self.mu.to(device), self.sigma.to(device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mu.to(x)) / self.sigma.to(x)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.sigma.to(z) + self.mu.to(z)

    __call__ = transform
