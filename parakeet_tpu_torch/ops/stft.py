"""STFT as matmuls against a windowed DFT basis (counterpart of
``parakeet_tpu/ops/stft.py``).

frames (B, F, n_fft) @ basis (n_fft, n_bins), in float32.  The JAX code
asks for ``Precision.HIGHEST`` because the basis feeds log-magnitude
losses; the counterpart here is float32 matmuls without TF32, which
``_highest_precision`` enforces around the products on every device.
Differentiable; used by the multi-resolution STFT losses.  The mel
functions project the magnitude onto ``audio/spectrum.py``'s filterbank.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _signal

from ..audio.spectrum import mel_filterbank

__all__ = ["dft_basis", "frame", "stft", "stft_magnitude", "mel_spectrogram",
           "log_mel_spectrogram"]


@functools.lru_cache(maxsize=32)
def dft_basis(n_fft: int, win_length: int, window: str = "hann"
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis, two (n_fft, 1 + n_fft // 2) float32 arrays.

    ``real[n, k] = w[n] cos(2 pi n k / N)``, ``imag[n, k] = -w[n] sin(...)``
    with the periodic window zero-padded centered to ``n_fft``.
    """
    win = _signal.get_window(window, win_length, fftbins=True)
    lpad = (n_fft - win_length) // 2
    w = np.zeros(n_fft)
    w[lpad:lpad + win_length] = win
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    real = (w[:, None] * np.cos(ang)).astype(np.float32)
    imag = (-w[:, None] * np.sin(ang)).astype(np.float32)
    return real, imag


@functools.lru_cache(maxsize=16)
def _basis(n_fft: int, win_length: int, window: str,
           device: torch.device) -> torch.Tensor:
    """[real | imag] basis on ``device``, uploaded once: a copy from
    pageable host memory per call (16 MB at n_fft 2048) blocks the host."""
    real_b, imag_b = dft_basis(n_fft, win_length, window)
    return torch.from_numpy(np.concatenate([real_b, imag_b], axis=1)).to(
        device)


def frame(x: torch.Tensor, frame_length: int, hop_length: int,
          center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_length) overlapping frames."""
    if center:
        pad = frame_length // 2
        x = F.pad(x[:, None], (pad, pad), mode=pad_mode)[:, 0]
    return x.unfold(-1, frame_length, hop_length)


@contextlib.contextmanager
def _highest_precision():
    """float32 matmuls in full float32 (no TF32) inside the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True, pad_mode: str = "reflect"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real/imag STFT of (B, T) -> two (B, n_frames, 1 + n_fft // 2)."""
    if win_length is None:
        win_length = n_fft
    frames = frame(x.float(), n_fft, hop_length, center, pad_mode)
    basis = _basis(n_fft, win_length, window, frames.device)
    with _highest_precision():
        out = frames @ basis
    n_bins = basis.shape[1] // 2
    return out[..., :n_bins], out[..., n_bins:]


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None, window: str = "hann",
                   center: bool = True, pad_mode: str = "reflect",
                   eps: float = 1e-7) -> torch.Tensor:
    """sqrt(clip(re^2 + im^2, eps)) -- (B, n_frames, n_bins)."""
    real, imag = stft(x, n_fft, hop_length, win_length, window, center,
                      pad_mode)
    return torch.sqrt(torch.clamp(real * real + imag * imag, min=eps))


@functools.lru_cache(maxsize=16)
def _mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
               fmax: Optional[float], device: torch.device) -> torch.Tensor:
    """(n_bins, n_mels) filterbank on ``device``, uploaded once."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop_length: int,
                    win_length: Optional[int] = None, window: str = "hann",
                    n_mels: int = 80, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_mels) linear mel magnitude."""
    mag = stft_magnitude(x, n_fft, hop_length, win_length, window, eps=0.0)
    with _highest_precision():
        return mag @ _mel_basis(sr, n_fft, n_mels, fmin, fmax, mag.device)


def log_mel_spectrogram(x: torch.Tensor, *, base: str = "10",
                        eps: float = 1e-10, **kwargs) -> torch.Tensor:
    """Log (base 10 or e) mel spectrogram, as ``LogMelFBank``."""
    log = torch.log(torch.clamp(mel_spectrogram(x, **kwargs), min=eps))
    if base == "10":
        log = log / math.log(10.0)
    return log
