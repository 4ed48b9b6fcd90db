"""flax's BatchNorm on feature-last tensors, over torch ``BatchNorm1d``'s
tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["flax_batch_norm"]

_BN_EPS = 1e-5          # flax BatchNorm's default epsilon
_BN_MOMENTUM = 0.99     # flax BatchNorm's default momentum


def _batch_norm_train(bn: nn.BatchNorm1d, h: torch.Tensor,
                      momentum: float = _BN_MOMENTUM) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` on (B, T, C): normalize
    with the batch's mean and *biased* variance over (B, T), computed in
    float32 as E[x^2] - E[x]^2 clipped at 0, and update the running
    statistics in place as flax does, ``ra = momentum ra + (1 - momentum)
    batch`` (flax's default momentum 0.99).
    ``torch.nn.BatchNorm1d``'s own update would use the unbiased variance
    and the other momentum convention, so only its tensors are used."""
    x = h.float()
    mean = x.mean(dim=(0, 1))
    var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean) * mul + bn.bias).to(h.dtype)


def flax_batch_norm(bn: nn.BatchNorm1d, h: torch.Tensor, *,
                    deterministic: bool,
                    momentum: float = _BN_MOMENTUM) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=deterministic,
    momentum=momentum)`` over the last axis of (B, T, C): the running
    statistics when deterministic, else ``_batch_norm_train``.  Under
    flax's mixed precision (``h`` in another dtype than the parameters',
    bf16 after a bf16 convolution) it normalizes in float32 and returns
    ``h``'s dtype, as flax's ``BatchNorm(dtype=...)``."""
    if not deterministic:
        return _batch_norm_train(bn, h, momentum)
    if h.dtype != bn.weight.dtype:  # flax's mixed precision: in float32
        return flax_batch_norm(bn, h.float(), deterministic=True).to(h.dtype)
    return F.batch_norm(h.transpose(1, 2), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, training=False,
                        eps=bn.eps).transpose(1, 2)
