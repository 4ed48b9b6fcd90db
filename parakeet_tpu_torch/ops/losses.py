"""Masked and weighted loss primitives and the guided-attention loss
(counterpart of ``parakeet_tpu/ops/losses.py``; reference:
parakeet/modules/losses.py:26-125), the parts SpeedySpeech and Tacotron2
use.  Masks are float or bool tensors broadcastable to the loss term."""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from .masking import sequence_mask

__all__ = ["weighted_mean", "masked_l1_loss", "stop_token_bce",
           "attention_guide", "guided_attention_loss"]


def weighted_mean(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum(x * w) / sum(w), with w broadcast against x; when ``weight``
    broadcasts over extra axes of ``x`` the denominator counts them, so the
    result is a true mean over the unmasked elements."""
    weight = weight.to(x.dtype)
    broadcast_ratio = x.numel() / max(weight.numel(), 1)
    denom = weight.sum() * broadcast_ratio
    return (x * weight).sum() / torch.clamp(denom, min=1e-12)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return weighted_mean(torch.abs(pred - target), mask)


def stop_token_bce(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   pos_weight: Union[float, torch.Tensor] = 1.0
                   ) -> torch.Tensor:
    """Binary cross entropy with logits and a positive-class weight, the
    mean over ``mask`` (every element without one)."""
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    if mask is None:
        return per.mean()
    return weighted_mean(per, mask)


def attention_guide(dec_lens: torch.Tensor, enc_lens: torch.Tensor,
                    n_dec: int, n_enc: int, g: float,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Guided-attention penalty W (B, n_dec, n_enc):
    ``1 - exp(-(n / dec_len - t / enc_len)^2 / (2 g^2))``, zero outside
    each utterance's (dec, enc) span (Tachibana et al. 2017)."""
    dev = dec_lens.device
    dec_pos = (torch.arange(n_dec, dtype=dtype, device=dev)[None, :]
               / dec_lens[:, None])
    enc_pos = (torch.arange(n_enc, dtype=dtype, device=dev)[None, :]
               / enc_lens[:, None])
    w = 1.0 - torch.exp(-((dec_pos[:, :, None] - enc_pos[:, None, :]) ** 2)
                        / (2 * g * g))
    mask = (sequence_mask(dec_lens, n_dec)[:, :, None]
            & sequence_mask(enc_lens, n_enc)[:, None, :])
    return w * mask.to(dtype)


def guided_attention_loss(attn: torch.Tensor, dec_lens: torch.Tensor,
                          enc_lens: torch.Tensor, g: float) -> torch.Tensor:
    """Mean over the batch of sum(W * A) / (dec_len * enc_len), ``attn``
    (B, n_dec, n_enc) attention weights."""
    _, n_dec, n_enc = attn.shape
    w = attention_guide(dec_lens, enc_lens, n_dec, n_enc, g, attn.dtype)
    total = (dec_lens * enc_lens).to(attn.dtype)
    return ((w * attn).sum(dim=(1, 2)) / total).mean()
