"""TransformerTTS (counterpart of ``parakeet_tpu/models/transformer_tts.py``;
reference: parakeet/models/transformer_tts/transformer_tts.py:172-1082):
an autoregressive transformer text -> mel model.

Token ids (+ ``<eos>``) -> an embedding, or the encoder prenet's
convolutions, -> a transformer encoder (+ GST style, + speaker embedding)
-> a decoder prenet and projection -> a causal transformer decoder with
cross-attention -> frame and stop projections, ``reduction_factor``
frames a step -> the Postnet residual.  Submodules keep the flax names,
so ``bridge.py`` loads a JAX checkpoint.

- Teacher forcing runs the decoder over every step at once under a causal
  mask, as the JAX ``__call__`` does.
- ``inference`` runs all ``max_decoder_steps`` steps with a ``finished``
  flag per utterance, never a host-side break: the Postnet reads the
  frames made after a stop before they are zeroed.  Each self-attention
  keeps a ``KVCache``; the cross-attention keys and values, the
  positional table and the decoder prenet's always-on dropout masks are
  made before the loop, and the loop reads nothing back to the host, so
  the whole of ``inference`` may be captured in one CUDA graph.

As in flax, ``deterministic`` (default True) turns off every dropout but
the decoder prenet's and selects BatchNorm's running statistics; every
mask is drawn from the ``torch.Generator`` ``rng``.  The compute dtype is
the parameters'.  The JAX package's ``concat_after`` and "linear" decoder
input layer are refused (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import SameConv1d
from ..nn.dropout import Dropout
from ..nn.initializer import init_flax_defaults_
from ..nn.postnet import _BN_EPS, Postnet, Prenet, flax_batch_norm
from ..nn.style_encoder import StyleEncoder
from ..nn.transformer import TransformerDecoder, TransformerEncoder
from ..ops.losses import attention_guide, stop_token_bce, weighted_mean
from ..ops.masking import sequence_mask
from ..ops.positional import sinusoid_position_encoding

__all__ = ["TransformerTTS", "EncoderPrenet", "transformer_tts_loss",
           "guided_multihead_attention_loss", "init_transformer_tts_"]


class EncoderPrenet(nn.Module):
    """Embedding (padding ids zeroed) -> ``conv_layers`` x (convolution
    (+ BatchNorm), ReLU, dropout) -> projection to ``d_model``."""

    def __init__(self, vocab_size: int, embed_dim: int = 512,
                 conv_layers: int = 3, conv_chans: int = 256,
                 conv_filts: int = 5, d_model: int = 512,
                 dropout_rate: float = 0.5, use_batch_norm: bool = True,
                 padding_idx: int = 0):
        super().__init__()
        self.conv_layers, self.use_batch_norm = conv_layers, use_batch_norm
        self.padding_idx = padding_idx
        self.embed = nn.Embedding(vocab_size, embed_dim)
        for i in range(conv_layers):
            self.add_module(f"conv_{i}", SameConv1d(
                embed_dim if i == 0 else conv_chans, conv_chans, conv_filts,
                bias=not use_batch_norm))
            if use_batch_norm:
                self.add_module(f"bn_{i}", nn.BatchNorm1d(conv_chans,
                                                          eps=_BN_EPS))
        self.dropout = Dropout(dropout_rate)
        self.proj = nn.Linear(conv_chans if conv_layers else embed_dim,
                              d_model)

    def forward(self, text, *, deterministic: bool = True, rng=None):
        emb = self.embed(text)
        h = emb * (text != self.padding_idx)[..., None].to(emb.dtype)
        for i in range(self.conv_layers):
            h = getattr(self, f"conv_{i}")(h)
            if self.use_batch_norm:
                h = flax_batch_norm(getattr(self, f"bn_{i}"), h,
                                    deterministic=deterministic)
            h = self.dropout(torch.relu(h), deterministic=deterministic,
                             rng=rng)
        return self.proj(h)


class TransformerTTS(nn.Module):
    """Constructor arguments keep the JAX module's (and the recipe YAML's)
    names; ``odim`` is the number of mel bands."""

    def __init__(self, idim: int, odim: int, embed_dim: int = 512,
                 eprenet_conv_layers: int = 3, eprenet_conv_chans: int = 256,
                 eprenet_conv_filts: int = 5, dprenet_layers: int = 2,
                 dprenet_units: int = 256, elayers: int = 6,
                 eunits: int = 1024, adim: int = 512, aheads: int = 4,
                 dlayers: int = 6, dunits: int = 1024,
                 postnet_layers: int = 5, postnet_chans: int = 256,
                 postnet_filts: int = 5,
                 positionwise_layer_type: str = "conv1d",
                 positionwise_conv_kernel_size: int = 1,
                 use_scaled_pos_enc: bool = True,
                 use_batch_norm: bool = True,
                 encoder_normalize_before: bool = True,
                 decoder_normalize_before: bool = True,
                 encoder_concat_after: bool = False,
                 decoder_concat_after: bool = False,
                 reduction_factor: int = 1,
                 spk_embed_dim: Optional[int] = None,
                 spk_embed_integration_type: str = "add",
                 use_gst: bool = False, gst_tokens: int = 10,
                 gst_heads: int = 4, gst_conv_layers: int = 6,
                 gst_conv_chans_list=(32, 32, 64, 64, 128, 128),
                 gst_conv_kernel_size: int = 3, gst_conv_stride: int = 2,
                 gst_gru_layers: int = 1, gst_gru_units: int = 128,
                 transformer_enc_dropout_rate: float = 0.1,
                 transformer_enc_positional_dropout_rate: float = 0.1,
                 transformer_enc_attn_dropout_rate: float = 0.1,
                 transformer_dec_dropout_rate: float = 0.1,
                 transformer_dec_positional_dropout_rate: float = 0.1,
                 transformer_dec_attn_dropout_rate: float = 0.1,
                 transformer_enc_dec_attn_dropout_rate: float = 0.1,
                 init_enc_alpha: float = 1.0, init_dec_alpha: float = 1.0,
                 eprenet_dropout_rate: float = 0.5,
                 dprenet_dropout_rate: float = 0.5,
                 postnet_dropout_rate: float = 0.5, padding_idx: int = 0):
        super().__init__()
        self.idim, self.odim, self.adim = idim, odim, adim
        self.reduction_factor = reduction_factor
        self.use_gst = use_gst
        self.spk_embed_dim = spk_embed_dim
        self.spk_embed_integration_type = spk_embed_integration_type
        if eprenet_conv_layers:
            self.encoder_prenet = EncoderPrenet(
                idim, embed_dim, eprenet_conv_layers, eprenet_conv_chans,
                eprenet_conv_filts, adim, eprenet_dropout_rate,
                use_batch_norm, padding_idx)
        else:
            self.encoder_prenet = None
        self.encoder = TransformerEncoder(
            adim, aheads, eunits, elayers,
            input_layer=None if eprenet_conv_layers else "embed",
            vocab_size=idim, dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attn_dropout_rate=transformer_enc_attn_dropout_rate,
            use_scaled_pos_enc=use_scaled_pos_enc, init_alpha=init_enc_alpha,
            normalize_before=encoder_normalize_before,
            concat_after=encoder_concat_after,
            positionwise_layer_type=positionwise_layer_type,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            padding_idx=padding_idx)
        if use_gst:
            self.gst = StyleEncoder(odim, gst_tokens, adim, gst_heads,
                                    gst_conv_layers, gst_conv_chans_list,
                                    gst_conv_kernel_size, gst_conv_stride,
                                    gst_gru_layers, gst_gru_units)
        if spk_embed_dim is not None:
            self.spk_projection = nn.Linear(
                spk_embed_dim if spk_embed_integration_type == "add"
                else adim + spk_embed_dim, adim)
        self.decoder_prenet = Prenet(odim, dprenet_layers, dprenet_units,
                                     dprenet_dropout_rate,
                                     always_dropout=True)
        self.decoder_prenet_proj = nn.Linear(dprenet_units, adim)
        self.decoder = TransformerDecoder(
            adim, aheads, dunits, dlayers,
            dropout_rate=transformer_dec_dropout_rate,
            positional_dropout_rate=transformer_dec_positional_dropout_rate,
            attn_dropout_rate=transformer_dec_attn_dropout_rate,
            src_attn_dropout_rate=transformer_enc_dec_attn_dropout_rate,
            use_scaled_pos_enc=use_scaled_pos_enc, init_alpha=init_dec_alpha,
            normalize_before=decoder_normalize_before,
            concat_after=decoder_concat_after)
        self.feat_out = nn.Linear(adim, odim * reduction_factor)
        self.prob_out = nn.Linear(adim, reduction_factor)
        self.postnet = Postnet(odim, postnet_layers, postnet_chans,
                               postnet_filts, use_batch_norm,
                               postnet_dropout_rate)

    def encode(self, text, text_lengths, speech=None, spk_emb=None, *,
               deterministic: bool = True, rng=None):
        """(hs (B, T_enc + 1, adim), mask (B, T_enc + 1), encoder attention
        weights (L, B, H, T, T)): ``<eos> = idim - 1`` is written at each
        utterance's length in one extra column."""
        kw = dict(deterministic=deterministic, rng=rng)
        text = F.pad(text, (0, 1)).scatter(1, text_lengths[:, None].to(
            torch.int64), self.idim - 1)
        mask = sequence_mask(text_lengths + 1, text.shape[1])
        x = (text if self.encoder_prenet is None
             else self.encoder_prenet(text, **kw))
        hs, enc_attns = self.encoder(x, mask[:, None, None, :],
                                     return_attns=True, **kw)
        if self.use_gst:
            style = (torch.zeros((hs.shape[0], self.adim), dtype=hs.dtype,
                                 device=hs.device) if speech is None
                     else self.gst(speech))
            hs = hs + style[:, None, :]
        if self.spk_embed_dim is not None and spk_emb is not None:
            spk_emb = spk_emb.to(hs.dtype)
            if self.spk_embed_integration_type == "add":
                norm = spk_emb / torch.clamp(
                    torch.linalg.norm(spk_emb, dim=-1, keepdim=True),
                    min=1e-12)
                hs = hs + self.spk_projection(norm)[:, None, :]
            else:
                g = spk_emb[:, None, :].expand(-1, hs.shape[1], -1)
                hs = self.spk_projection(torch.cat([hs, g], dim=-1))
        return hs, mask, enc_attns

    def _decoder_input(self, frames, *, keep=None, **kw):
        return self.decoder_prenet_proj(self.decoder_prenet(frames, keep=keep,
                                                            **kw))

    def forward(self, text, text_lengths, speech, speech_lengths,
                spk_emb=None, *, deterministic: bool = True, rng=None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: before_outs, after_outs (B, steps r,
        odim), stop_logits (B, steps r), enc_attns (L, B, H, T_enc,
        T_enc), dec_self_attns (L, B, H, steps, steps) and dec_cross_attns
        (L, B, H, steps, T_enc)."""
        kw = dict(deterministic=deterministic, rng=rng)
        hs, enc_mask, enc_attns = self.encode(text, text_lengths, speech,
                                              spk_emb, **kw)
        b, r = text.shape[0], self.reduction_factor
        n_steps = speech.shape[1] // r
        # the last frame of each reduction group, shifted right
        ys_in = speech[:, r - 1::r, :]
        ys_in = torch.cat([torch.zeros_like(ys_in[:, :1]), ys_in[:, :-1]],
                          dim=1)
        d_in = self._decoder_input(ys_in, **kw)
        dec_mask = sequence_mask(torch.div(speech_lengths, r,
                                           rounding_mode="floor"), n_steps)
        causal = torch.ones((n_steps, n_steps), dtype=torch.bool,
                            device=speech.device).tril()
        self_mask = dec_mask[:, None, None, :] & causal[None, None]
        zs, self_attns, cross_attns = self.decoder(
            d_in, hs, self_mask, enc_mask[:, None, None, :], **kw)
        before = self.feat_out(zs).reshape(b, n_steps * r, self.odim)
        logits = self.prob_out(zs).reshape(b, n_steps * r)
        return {"before_outs": before,
                "after_outs": before + self.postnet(before, **kw),
                "stop_logits": logits, "enc_attns": enc_attns,
                "dec_self_attns": self_attns,
                "dec_cross_attns": cross_attns}

    def prenet_masks(self, batch: int, max_decoder_steps: int,
                     rng: torch.Generator, device) -> Optional[torch.Tensor]:
        """The decoder prenet's keep-masks of every step of ``inference``,
        (layers, steps, B, 1, units), drawn from ``rng``; None when it
        drops nothing."""
        if not self.decoder_prenet.drops(True):
            return None
        return self.decoder_prenet.keep_masks((max_decoder_steps, batch, 1),
                                              rng, device)

    def inference(self, text, text_lengths, spk_emb=None, speech=None,
                  max_decoder_steps: int = 500, threshold: float = 0.5,
                  min_decoder_steps: int = 10, *, deterministic: bool = True,
                  rng=None, prenet_keep=None) -> Dict[str, torch.Tensor]:
        """Free-running decode over exactly ``max_decoder_steps`` steps.

        An utterance finishes at the first step, from step
        ``min_decoder_steps`` on, where any of its r stop probabilities
        exceeds ``threshold``; each step emits while the utterance had not
        finished before it.  ``prenet_keep`` (``prenet_masks``) holds the
        decoder prenet's masks, else they are drawn from ``rng`` before the
        loop.  Returns mel (B, steps r, odim), zero past each utterance's
        frames, lengths (B,) and the last query's cross-attention weights
        of every step and layer, (L, steps, B, H, T_enc)."""
        kw = dict(deterministic=deterministic, rng=rng)
        hs, enc_mask, _ = self.encode(text, text_lengths, speech, spk_emb,
                                      **kw)
        b, r, t_max = text.shape[0], self.reduction_factor, max_decoder_steps
        dtype, device = hs.dtype, hs.device
        if prenet_keep is None:
            prenet_keep = self.prenet_masks(b, t_max, rng, device)
        caches = self.decoder.new_caches(b, t_max, dtype, device)
        # loop-invariant: the cross-attention K/V of every layer, the
        # positional table and the cross mask
        cross_kvs = self.decoder.precompute_cross_kv(hs)
        pe_table = sinusoid_position_encoding(t_max, self.adim, dtype=dtype,
                                              device=device)
        cross_mask = enc_mask[:, None, None, :]
        prev = torch.zeros((b, 1, self.odim), dtype=dtype, device=device)
        finished = torch.zeros((b,), dtype=torch.bool, device=device)
        frames, crosses, valid = [], [], []
        for t in range(t_max):
            d_in = self._decoder_input(
                prev, keep=None if prenet_keep is None
                else prenet_keep[:, t], **kw)
            zs, _, ca = self.decoder(
                d_in, hs, None, cross_mask, caches=caches, start_pos=t,
                cross_kvs=cross_kvs, pos_pe=pe_table[None, t:t + 1], **kw)
            z = zs[:, -1]
            frame = self.feat_out(z).reshape(b, r, self.odim)
            valid.append(~finished)
            if t + 1 >= min_decoder_steps:
                logits = self.prob_out(z)
                finished = finished | (torch.sigmoid(logits)
                                       > threshold).any(-1)
            prev = frame[:, -1:, :]
            frames.append(frame)
            crosses.append(ca[:, :, :, -1, :])
        mel = torch.stack(frames, 1).reshape(b, t_max * r, self.odim)
        mel = mel + self.postnet(mel, **kw)
        valid_frames = torch.stack(valid, 1).repeat_interleave(r, dim=1)
        mel = mel * valid_frames[..., None].to(mel.dtype)
        return {"mel": mel,
                "lengths": valid_frames.sum(1, dtype=torch.int32),
                "cross_attns": torch.stack(crosses, 1)}


@torch.no_grad()
def init_transformer_tts_(model: TransformerTTS,
                          gen: torch.Generator) -> None:
    """flax's initializers for the JAX module, from ``gen``: the defaults
    (``init_flax_defaults_``) and GST's tokens N(0, 0.5^2)."""
    init_flax_defaults_(model, gen)
    if model.use_gst:
        model.gst.stl.gst_tokens_param.normal_(0.0, 0.5, generator=gen)


def transformer_tts_loss(outputs: Dict[str, torch.Tensor],
                         speech: torch.Tensor, speech_lengths: torch.Tensor,
                         *, loss_type: str = "L1",
                         bce_pos_weight: float = 5.0
                         ) -> Dict[str, torch.Tensor]:
    """Masked L1 and/or L2 of the before and after outputs against
    ``speech``, + the stop BCE with the label 1 at each utterance's last
    valid frame (masked by its frames); returns 0-d tensors: [l1_loss]
    [l2_loss] bce_loss loss."""
    t_dec = speech.shape[1]
    mask = sequence_mask(speech_lengths, t_dec).to(speech.dtype)
    m3 = mask[..., None]

    def _mean(err):
        return weighted_mean(err, m3.expand_as(err))

    losses = {}
    loss = 0.0
    if loss_type in ("L1", "L1+L2"):
        losses["l1_loss"] = (_mean(torch.abs(outputs["before_outs"] - speech))
                             + _mean(torch.abs(outputs["after_outs"]
                                               - speech)))
        loss = loss + losses["l1_loss"]
    if loss_type in ("L2", "L1+L2"):
        losses["l2_loss"] = (_mean(torch.square(outputs["before_outs"]
                                                - speech))
                             + _mean(torch.square(outputs["after_outs"]
                                                  - speech)))
        loss = loss + losses["l2_loss"]
    logits = outputs["stop_logits"]
    idx = torch.arange(t_dec, device=speech.device)[None, :]
    labels = (idx == (speech_lengths - 1)[:, None]).to(logits.dtype)
    losses["bce_loss"] = stop_token_bce(logits, labels, mask=mask,
                                        pos_weight=bce_pos_weight)
    losses["loss"] = loss + losses["bce_loss"]
    return losses


def guided_multihead_attention_loss(attns: torch.Tensor,
                                    dec_lens: torch.Tensor,
                                    enc_lens: torch.Tensor, *,
                                    sigma: float = 0.4,
                                    num_layers: Optional[int] = None,
                                    num_heads: Optional[int] = None
                                    ) -> torch.Tensor:
    """The guided-attention loss over the last ``num_layers`` layers and
    the first ``num_heads`` heads of an (L, B, H, T_dec, T_enc) stack:
    the mean over the batch of each utterance's penalty sum over its
    valid (dec, enc) cells times the layers and heads."""
    l_total, _, h_total, n_dec, n_enc = attns.shape
    nl, nh = num_layers or l_total, num_heads or h_total
    sel = attns[l_total - nl:, :, :nh]
    w = attention_guide(dec_lens, enc_lens, n_dec, n_enc, sigma, attns.dtype)
    valid = (sequence_mask(dec_lens, n_dec)[:, :, None]
             & sequence_mask(enc_lens, n_enc)[:, None, :])
    num = (sel * w[None, :, None]).sum(dim=(0, 2, 3, 4))
    den = torch.clamp(valid.to(attns.dtype).sum(dim=(1, 2)) * nl * nh,
                      min=1.0)
    return (num / den).mean()
