"""Spectral losses for vocoder training (counterpart of
``parakeet_tpu/ops/stft_loss.py``): multi-resolution FFT sizes
(1024, 2048, 512), hops (120, 240, 50), windows (600, 1200, 240),
averaged over resolutions."""
from __future__ import annotations

from typing import Tuple

import torch

from .stft import stft_magnitude

__all__ = ["spectral_convergence_loss", "log_stft_magnitude_loss",
           "stft_loss", "multi_resolution_stft_loss"]


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor
                              ) -> torch.Tensor:
    """||y - x||_F / ||y||_F over the whole batch."""
    num = torch.sqrt(torch.sum(torch.square(y_mag - x_mag)))
    den = torch.sqrt(torch.sum(torch.square(y_mag)))
    return num / torch.clamp(den, min=1e-10)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor,
                            eps: float = 1e-7) -> torch.Tensor:
    """L1 between log magnitudes."""
    return torch.mean(torch.abs(torch.log(torch.clamp(y_mag, min=eps))
                                - torch.log(torch.clamp(x_mag, min=eps))))


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int = 1024,
              hop_length: int = 120, win_length: int = 600,
              window: str = "hann") -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc_loss, mag_loss) between predicted x and target y, both (B, T)."""
    x_mag = stft_magnitude(x, fft_size, hop_length, win_length, window)
    y_mag = stft_magnitude(y, fft_size, hop_length, win_length, window)
    return (spectral_convergence_loss(x_mag, y_mag),
            log_stft_magnitude_loss(x_mag, y_mag))


def multi_resolution_stft_loss(
        x: torch.Tensor, y: torch.Tensor,
        fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
        win_lengths=(600, 1200, 240), window: str = "hann"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Averaged (sc, mag) losses over resolutions; x, y: (B, T) or
    (B, C, T)."""
    if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
        raise ValueError("fft_sizes, hop_sizes and win_lengths differ in "
                         "length")
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
        y = y.reshape(-1, y.shape[-1])
    sc_total = mag_total = 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, hs, wl, window)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_sizes)
    return sc_total / n, mag_total / n
