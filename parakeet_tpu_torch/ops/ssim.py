"""Structural similarity (SSIM) between spectrogram "images" (counterpart
of ``parakeet_tpu/ops/ssim.py``): an 11 x 11 Gaussian window (sigma 1.5)
applied to each channel with SAME zero padding, in float32 whatever the
inputs' type.  SpeedySpeech's loss takes 1 - SSIM of the masked mels."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim"]


@functools.lru_cache(maxsize=8)
def _gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(win_size) - win_size // 2) ** 2)
               / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)[None, None]   # (1, 1, K, K)


def _filter2d(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D convolution of (B, C, H, W) with SAME zero padding."""
    c, k = x.shape[1], window.shape[-1]
    lo, hi = (k - 1) // 2, k // 2
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(x, window.expand(c, 1, k, k), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, win_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM of two batches of images (B, C, H, W), a 0-d float32
    tensor."""
    img1, img2 = img1.float(), img2.float()
    w = torch.from_numpy(_gaussian_window(win_size, sigma)).to(img1.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu1 = _filter2d(img1, w)
    mu2 = _filter2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, w) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, w) - mu2_sq
    sigma12 = _filter2d(img1 * img2, w) - mu12

    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
