"""Location-sensitive attention (counterpart of
``parakeet_tpu/nn/attention.py::LocationSensitiveAttention``; reference:
parakeet/modules/attention.py:258-348), Tacotron2's aligner.

One decoder step at a time: ``process_keys`` projects the keys once per
utterance, outside the decode loop; each step scores the query against
them with the location feature, a bias-free SAME convolution (kernel 31)
over the stacked [previous, cumulative] attention weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .conv import SameConv1d

__all__ = ["LocationSensitiveAttention"]

_NEG_INF = -1e9


class LocationSensitiveAttention(nn.Module):
    """score_i = v . tanh(W_q q + W_k k_i + W_f f_i); the softmax runs in
    float32 and the weights return in the parameters' type."""

    def __init__(self, d_query: int, d_key: int, d_attention: int,
                 location_filters: int = 32, location_kernel_size: int = 31):
        super().__init__()
        self.query_layer = nn.Linear(d_query, d_attention, bias=False)
        self.key_layer = nn.Linear(d_key, d_attention, bias=False)
        self.location_conv = SameConv1d(2, location_filters,
                                        location_kernel_size, bias=False)
        self.location_layer = nn.Linear(location_filters, d_attention,
                                        bias=False)
        self.value = nn.Linear(d_attention, 1, bias=False)

    def process_keys(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, T, d_k) -> (B, T, d_attention); once, outside the loop."""
        return self.key_layer(keys)

    def forward(self, query: torch.Tensor, processed_keys: torch.Tensor,
                values: torch.Tensor, attention_weights: torch.Tensor,
                cum_attention_weights: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One alignment step: query (B, d_q), processed_keys (B, T,
        d_att), values (B, T, d_v), the previous and cumulative weights
        (B, T), mask (B, T) True at valid keys.  Returns (context (B, d_v),
        weights (B, T))."""
        dtype = self.value.weight.dtype
        processed_query = self.query_layer(query)[:, None, :]
        location = torch.stack([attention_weights, cum_attention_weights],
                               dim=-1).to(dtype)
        processed_location = self.location_layer(
            self.location_conv(location))
        energies = self.value(torch.tanh(
            processed_query + processed_keys + processed_location))[..., 0]
        if mask is not None:
            energies = torch.where(mask, energies,
                                   torch.full_like(energies, _NEG_INF))
        weights = torch.softmax(energies.float(), dim=-1).to(dtype)
        context = torch.bmm(weights[:, None, :], values.to(dtype))[:, 0]
        return context, weights
