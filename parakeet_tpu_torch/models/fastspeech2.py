"""FastSpeech2 inference (counterpart of
``parakeet_tpu/models/fastspeech2.py::FastSpeech2.inference``).

Constructor arguments keep the JAX module's hyperparameter names, so a
recipe's ``model`` section maps onto both.  Inference only: no dropout,
no training forward, no loss.  Speakers are supported with the "add"
integration; tone embeddings and the "concat" integration are not ported
yet.  The compute dtype is the parameters' dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.postnet import Postnet
from ..nn.predictors import (DurationPredictor, VarianceEmbedding,
                             VariancePredictor)
from ..nn.transformer import TransformerEncoder
from ..ops.length_regulator import length_regulate
from ..ops.masking import sequence_mask

__all__ = ["FastSpeech2"]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps))


class FastSpeech2(nn.Module):
    """Text -> mel with token-averaged pitch and energy; see module doc."""

    def __init__(self, idim: int, odim: int, adim: int = 384,
                 aheads: int = 4, elayers: int = 6, eunits: int = 1536,
                 dlayers: int = 6, dunits: int = 1536,
                 postnet_layers: int = 5, postnet_chans: int = 512,
                 postnet_filts: int = 5,
                 positionwise_layer_type: str = "conv1d",
                 positionwise_conv_kernel_size: int = 1,
                 use_scaled_pos_enc: bool = True,
                 init_enc_alpha: float = 1.0, init_dec_alpha: float = 1.0,
                 use_batch_norm: bool = True,
                 encoder_normalize_before: bool = True,
                 decoder_normalize_before: bool = True,
                 reduction_factor: int = 1,
                 duration_predictor_layers: int = 2,
                 duration_predictor_chans: int = 384,
                 duration_predictor_kernel_size: int = 3,
                 energy_predictor_layers: int = 2,
                 energy_predictor_chans: int = 384,
                 energy_predictor_kernel_size: int = 3,
                 energy_embed_kernel_size: int = 9,
                 pitch_predictor_layers: int = 2,
                 pitch_predictor_chans: int = 384,
                 pitch_predictor_kernel_size: int = 3,
                 pitch_embed_kernel_size: int = 9,
                 num_speakers: Optional[int] = None,
                 spk_embed_dim: Optional[int] = None,
                 spk_embed_integration_type: str = "add",
                 attn_impl: str = "auto"):
        super().__init__()
        if spk_embed_dim is not None and spk_embed_integration_type != "add":
            raise NotImplementedError(
                "only spk_embed_integration_type='add' is ported")
        self.odim = odim
        self.reduction_factor = reduction_factor
        self.postnet_layers = postnet_layers
        self.spk_embed_dim = spk_embed_dim
        common = dict(d_model=adim, n_heads=aheads,
                      use_scaled_pos_enc=use_scaled_pos_enc,
                      positionwise_layer_type=positionwise_layer_type,
                      positionwise_conv_kernel_size=(
                          positionwise_conv_kernel_size),
                      attn_impl=attn_impl)
        self.encoder = TransformerEncoder(
            units=eunits, num_layers=elayers, input_layer="embed",
            vocab_size=idim, init_alpha=init_enc_alpha,
            normalize_before=encoder_normalize_before, **common)
        self.decoder = TransformerEncoder(
            units=dunits, num_layers=dlayers, input_layer=None,
            init_alpha=init_dec_alpha,
            normalize_before=decoder_normalize_before, **common)
        self.duration_predictor = DurationPredictor(
            adim, duration_predictor_layers, duration_predictor_chans,
            duration_predictor_kernel_size)
        self.pitch_predictor = VariancePredictor(
            adim, pitch_predictor_layers, pitch_predictor_chans,
            pitch_predictor_kernel_size)
        self.energy_predictor = VariancePredictor(
            adim, energy_predictor_layers, energy_predictor_chans,
            energy_predictor_kernel_size)
        self.pitch_embed = VarianceEmbedding(adim, pitch_embed_kernel_size)
        self.energy_embed = VarianceEmbedding(adim, energy_embed_kernel_size)
        self.feat_out = nn.Linear(adim, odim * reduction_factor)
        if postnet_layers > 0:
            self.postnet = Postnet(odim, postnet_layers, postnet_chans,
                                   postnet_filts, use_batch_norm)
        if spk_embed_dim is not None:
            if num_speakers is not None:
                self.spk_embedding_table = nn.Embedding(num_speakers,
                                                        spk_embed_dim)
            self.spk_projection = nn.Linear(spk_embed_dim, adim)

    def _encode(self, text, text_lengths, spk_id, spk_emb):
        x_mask = sequence_mask(text_lengths, text.shape[1])[:, None, :]
        hs = self.encoder(text, x_mask)
        if self.spk_embed_dim is not None:
            if spk_emb is None and spk_id is not None:
                spk_emb = self.spk_embedding_table(spk_id)
            if spk_emb is not None:
                hs = hs + self.spk_projection(
                    _l2_normalize(spk_emb.to(hs.dtype)))[:, None, :]
        return hs

    def _decode(self, hs, frame_lengths):
        h_mask = sequence_mask(frame_lengths, hs.shape[1])[:, None, :]
        zs = self.decoder(hs, h_mask)
        before = self.feat_out(zs).reshape(zs.shape[0], -1, self.odim)
        if self.postnet_layers > 0:
            return before + self.postnet(before)
        return before

    def inference(self, text: torch.Tensor, text_lengths: torch.Tensor, *,
                  max_frames: int, durations=None, pitch=None, energy=None,
                  alpha: float = 1.0, spk_id=None, spk_emb=None,
                  min_duration: int = 0) -> Dict[str, torch.Tensor]:
        """Free-running synthesis to a static ``max_frames`` capacity.

        ``min_duration`` > 0 floors each valid token's predicted duration.
        Returns dict: after_outs (B, max_frames, odim), frame_lengths
        (B,), d_outs (B, Tmax) integer durations (as floats).
        """
        r = self.reduction_factor
        hs = self._encode(text, text_lengths, spk_id, spk_emb)
        pad_mask = ~sequence_mask(text_lengths, text.shape[1])
        p_outs = pitch if pitch is not None else self.pitch_predictor(
            hs, pad_mask[..., None])
        e_outs = energy if energy is not None else self.energy_predictor(
            hs, pad_mask[..., None])
        if durations is not None:
            d_outs = durations
        else:
            d_outs = self.duration_predictor(hs, pad_mask, inference=True)
        if min_duration > 0:
            d_outs = torch.where(pad_mask, d_outs,
                                 torch.clamp(d_outs, min=min_duration))
        hs = (hs + self.pitch_embed(p_outs.to(hs.dtype))
              + self.energy_embed(e_outs.to(hs.dtype)))
        hs, total = length_regulate(hs, d_outs, max_len=max_frames // r,
                                    alpha=alpha)
        total = torch.clamp(total, max=max_frames // r)
        after = self._decode(hs, total)
        return {"after_outs": after, "frame_lengths": total * r,
                "d_outs": d_outs}
