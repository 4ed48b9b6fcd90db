"""FastSpeech2 (counterpart of ``parakeet_tpu/models/fastspeech2.py``):
the teacher-forced training forward, inference and the loss.

Constructor arguments keep the JAX module's hyperparameter names, so a
recipe's ``model`` section maps onto both.  Speakers and tones
(``num_tones``, ``tone_embed_dim``: a per-token tone embedding, L2
normalised, then projected) are supported with the "add" and "concat"
integrations.  ``dtype`` is flax's (``nn/precision.py``): with
``torch.bfloat16`` the parameters stay float32 and every layer computes in
bf16 at the JAX module's cast points (LayerNorm and BatchNorm statistics,
the dense attention's scores, softmax and context sums in float32); the
loss is float32.  ``None`` computes in the parameters' dtype.

``attn_impl`` selects the attention core of both transformer stacks, as
in the JAX package: 'dense' (scores in device memory; attention-weight
dropout), 'flash' (kernel K4 on CUDA tensors; training needs both
attention dropout rates at 0) or 'auto' (K4 once both lengths reach
``AUTO_FLASH_MIN_T`` at the head widths of ``auto_flash_head_dim``,
dense below it, at other widths (the recipes' dk 192) and when training
with attention dropout).

As in flax, ``forward`` takes ``deterministic`` (default False: dropout
on, BatchNorm on batch statistics, whose running averages it updates) and
the ``torch.Generator`` ``rng`` that every dropout mask is drawn from;
``inference`` is deterministic.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.flash import make_auto_attn_core, make_flash_attn_core
from ..nn.postnet import Postnet
from ..nn.precision import Dense, Embedding
from ..nn.predictors import (DurationPredictor, VarianceEmbedding,
                             VariancePredictor, duration_predictor_loss)
from ..nn.transformer import TransformerEncoder
from ..ops.length_regulator import length_regulate
from ..ops.masking import sequence_mask

__all__ = ["FastSpeech2", "fastspeech2_loss", "make_attn_core"]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps))


def make_attn_core(attn_impl: str):
    """The ``attn_core`` of an ``attn_impl``: None for 'dense'."""
    if attn_impl == "flash":
        return make_flash_attn_core()
    if attn_impl == "auto":
        return make_auto_attn_core()
    if attn_impl == "dense":
        return None
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


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
                 encoder_concat_after: bool = False,
                 decoder_concat_after: bool = False,
                 reduction_factor: int = 1,
                 duration_predictor_layers: int = 2,
                 duration_predictor_chans: int = 384,
                 duration_predictor_kernel_size: int = 3,
                 duration_predictor_dropout_rate: float = 0.1,
                 energy_predictor_layers: int = 2,
                 energy_predictor_chans: int = 384,
                 energy_predictor_kernel_size: int = 3,
                 energy_predictor_dropout: float = 0.5,
                 energy_embed_kernel_size: int = 9,
                 energy_embed_dropout: float = 0.5,
                 stop_gradient_from_energy_predictor: bool = False,
                 pitch_predictor_layers: int = 2,
                 pitch_predictor_chans: int = 384,
                 pitch_predictor_kernel_size: int = 3,
                 pitch_predictor_dropout: float = 0.5,
                 pitch_embed_kernel_size: int = 9,
                 pitch_embed_dropout: float = 0.5,
                 stop_gradient_from_pitch_predictor: bool = False,
                 num_speakers: Optional[int] = None,
                 spk_embed_dim: Optional[int] = None,
                 spk_embed_integration_type: str = "add",
                 num_tones: Optional[int] = None,
                 tone_embed_dim: Optional[int] = None,
                 tone_embed_integration_type: str = "add",
                 transformer_enc_dropout_rate: float = 0.1,
                 transformer_enc_positional_dropout_rate: float = 0.1,
                 transformer_enc_attn_dropout_rate: float = 0.1,
                 transformer_dec_dropout_rate: float = 0.1,
                 transformer_dec_positional_dropout_rate: float = 0.1,
                 transformer_dec_attn_dropout_rate: float = 0.1,
                 postnet_dropout_rate: float = 0.5,
                 attn_impl: str = "auto",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for kind, value in (("spk", spk_embed_integration_type),
                            ("tone", tone_embed_integration_type)):
            if value not in ("add", "concat"):
                raise ValueError(f"unknown {kind}_embed_integration_type "
                                 f"{value!r}")
        self.odim = odim
        self.dtype = dtype
        self.reduction_factor = reduction_factor
        self.postnet_layers = postnet_layers
        self.spk_embed_dim = spk_embed_dim
        self.spk_embed_integration_type = spk_embed_integration_type
        self.tone_embed_dim = tone_embed_dim
        self.tone_embed_integration_type = tone_embed_integration_type
        self.stop_gradient_from_pitch_predictor = (
            stop_gradient_from_pitch_predictor)
        self.stop_gradient_from_energy_predictor = (
            stop_gradient_from_energy_predictor)
        common = dict(d_model=adim, n_heads=aheads,
                      use_scaled_pos_enc=use_scaled_pos_enc,
                      positionwise_layer_type=positionwise_layer_type,
                      positionwise_conv_kernel_size=(
                          positionwise_conv_kernel_size),
                      attn_core=make_attn_core(attn_impl), dtype=dtype)
        self.encoder = TransformerEncoder(
            units=eunits, num_layers=elayers, input_layer="embed",
            vocab_size=idim, init_alpha=init_enc_alpha,
            dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attn_dropout_rate=transformer_enc_attn_dropout_rate,
            normalize_before=encoder_normalize_before,
            concat_after=encoder_concat_after, **common)
        self.decoder = TransformerEncoder(
            units=dunits, num_layers=dlayers, input_layer=None,
            init_alpha=init_dec_alpha,
            dropout_rate=transformer_dec_dropout_rate,
            positional_dropout_rate=transformer_dec_positional_dropout_rate,
            attn_dropout_rate=transformer_dec_attn_dropout_rate,
            normalize_before=decoder_normalize_before,
            concat_after=decoder_concat_after, **common)
        self.duration_predictor = DurationPredictor(
            adim, duration_predictor_layers, duration_predictor_chans,
            duration_predictor_kernel_size, duration_predictor_dropout_rate,
            dtype=dtype)
        self.pitch_predictor = VariancePredictor(
            adim, pitch_predictor_layers, pitch_predictor_chans,
            pitch_predictor_kernel_size, pitch_predictor_dropout, dtype)
        self.energy_predictor = VariancePredictor(
            adim, energy_predictor_layers, energy_predictor_chans,
            energy_predictor_kernel_size, energy_predictor_dropout, dtype)
        self.pitch_embed = VarianceEmbedding(adim, pitch_embed_kernel_size,
                                             pitch_embed_dropout, dtype)
        self.energy_embed = VarianceEmbedding(adim, energy_embed_kernel_size,
                                              energy_embed_dropout, dtype)
        self.feat_out = Dense(adim, odim * reduction_factor, dtype=dtype)
        if postnet_layers > 0:
            self.postnet = Postnet(odim, postnet_layers, postnet_chans,
                                   postnet_filts, use_batch_norm,
                                   postnet_dropout_rate, dtype)
        if spk_embed_dim is not None:
            if num_speakers is not None:
                self.spk_embedding_table = Embedding(num_speakers,
                                                     spk_embed_dim, dtype)
            # "concat" projects [hs, speaker] (adim + spk_embed_dim) to adim
            self.spk_projection = Dense(
                spk_embed_dim + (adim if spk_embed_integration_type
                                 == "concat" else 0), adim, dtype=dtype)
        if tone_embed_dim is not None:
            self.tone_embedding_table = Embedding(num_tones, tone_embed_dim,
                                                  dtype)
            self.tone_projection = Dense(
                tone_embed_dim + (adim if tone_embed_integration_type
                                  == "concat" else 0), adim, dtype=dtype)

    def _encode(self, text, text_lengths, spk_id, spk_emb, tone_id=None,
                **kw):
        x_mask = sequence_mask(text_lengths, text.shape[1])[:, None, :]
        hs = self.encoder(text, x_mask, **kw)
        if self.spk_embed_dim is not None:
            if spk_emb is None and spk_id is not None:
                spk_emb = self.spk_embedding_table(spk_id)
            if spk_emb is not None:
                # normalized in its own dtype, as the JAX module does
                spk = _l2_normalize(spk_emb)
                if self.spk_embed_integration_type == "add":
                    hs = hs + self.spk_projection(spk)[:, None, :]
                else:
                    tiled = spk[:, None, :].expand(-1, hs.shape[1], -1)
                    hs = self.spk_projection(torch.cat([hs, tiled], dim=-1))
        if self.tone_embed_dim is not None and tone_id is not None:
            tone = _l2_normalize(self.tone_embedding_table(tone_id))
            if self.tone_embed_integration_type == "add":
                hs = hs + self.tone_projection(tone)
            else:
                hs = self.tone_projection(torch.cat([hs, tone], dim=-1))
        return hs

    def _decode(self, hs, frame_lengths, **kw):
        """(before_outs, after_outs), (B, frames * r, odim)."""
        h_mask = sequence_mask(frame_lengths, hs.shape[1])[:, None, :]
        zs = self.decoder(hs, h_mask, **kw)
        before = self.feat_out(zs).reshape(zs.shape[0], -1, self.odim)
        if self.postnet_layers > 0:
            return before, before + self.postnet(before, **kw)
        return before, before

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                speech: torch.Tensor, speech_lengths: torch.Tensor,
                durations: torch.Tensor, pitch: torch.Tensor,
                energy: torch.Tensor, spk_id=None, spk_emb=None,
                tone_id=None, *, deterministic: bool = False,
                rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced training forward (the JAX ``__call__``).

        Returns dict: before_outs, after_outs (B, Lmax, odim), d_outs
        (B, Tmax) log durations, p_outs / e_outs (B, Tmax, 1), olens (B,)
        target lengths trimmed to the reduction factor.
        """
        kw = dict(deterministic=deterministic, rng=rng)
        r = self.reduction_factor
        hs = self._encode(text, text_lengths, spk_id, spk_emb, tone_id, **kw)
        pad_mask = ~sequence_mask(text_lengths, text.shape[1])
        p_in = hs.detach() if self.stop_gradient_from_pitch_predictor else hs
        e_in = (hs.detach() if self.stop_gradient_from_energy_predictor
                else hs)
        p_outs = self.pitch_predictor(p_in, pad_mask[..., None], **kw)
        e_outs = self.energy_predictor(e_in, pad_mask[..., None], **kw)
        d_outs = self.duration_predictor(hs, pad_mask, **kw)
        hs = (hs + self.pitch_embed(pitch.to(hs.dtype), **kw)
              + self.energy_embed(energy.to(hs.dtype), **kw))
        olens = speech_lengths - speech_lengths % r
        hs, _ = length_regulate(hs, durations, max_len=speech.shape[1] // r)
        before, after = self._decode(hs, olens // r, **kw)
        return {"before_outs": before, "after_outs": after,
                "d_outs": d_outs, "p_outs": p_outs, "e_outs": e_outs,
                "olens": olens}

    def inference(self, text: torch.Tensor, text_lengths: torch.Tensor, *,
                  max_frames: int, durations=None, pitch=None, energy=None,
                  alpha: float = 1.0, spk_id=None, spk_emb=None,
                  tone_id=None, min_duration: int = 0) -> Dict[str, torch.Tensor]:
        """Free-running synthesis to a static ``max_frames`` capacity,
        deterministic (no dropout, BatchNorm's running statistics).

        ``min_duration`` > 0 floors each valid token's predicted duration.
        Returns dict: after_outs (B, max_frames, odim), frame_lengths
        (B,), d_outs (B, Tmax) integer durations (as floats).
        """
        r = self.reduction_factor
        hs = self._encode(text, text_lengths, spk_id, spk_emb, tone_id)
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
        _, after = self._decode(hs, total)
        return {"after_outs": after, "frame_lengths": total * r,
                "d_outs": d_outs}


def fastspeech2_loss(outputs: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor], use_masking: bool = True,
                     use_weighted_masking: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """L1 (before + after) + log-duration MSE + pitch / energy MSE, the
    counterpart of ``parakeet_tpu/models/fastspeech2.py::fastspeech2_loss``.
    Returns 0-d tensors: loss, l1_loss, duration_loss, pitch_loss,
    energy_loss."""
    ys = batch["speech"]
    ilens = batch["text_lengths"]
    before, after = outputs["before_outs"], outputs["after_outs"]
    d_outs, p_outs, e_outs = (outputs["d_outs"], outputs["p_outs"],
                              outputs["e_outs"])
    ds, ps, es = batch["durations"], batch["pitch"], batch["energy"]
    if use_masking or use_weighted_masking:
        out_mask = sequence_mask(outputs["olens"], ys.shape[1])[..., None]
        in_mask = sequence_mask(ilens, ds.shape[1])
    else:           # no masking at all: every element weighs in
        out_mask = torch.ones((*ys.shape[:2], 1), dtype=torch.bool,
                              device=ys.device)
        in_mask = torch.ones(ds.shape, dtype=torch.bool, device=ys.device)

    if use_weighted_masking:
        # per-sequence weights: each sequence contributes equally
        out_w = out_mask.float()
        out_w = out_w / torch.clamp(out_w.sum(1, keepdim=True), min=1.0)
        out_w = out_w / (ys.shape[0] * ys.shape[2])
        in_w = in_mask.float()
        in_w = in_w / torch.clamp(in_w.sum(1, keepdim=True), min=1.0)
        in_w = in_w / ds.shape[0]
        l1 = ((torch.abs(before - ys) * out_w).sum()
              + (torch.abs(after - ys) * out_w).sum())
        log_ds = torch.log(ds.float() + 1.0)
        dur = (torch.square(d_outs - log_ds) * in_w).sum()
        pitch = (torch.square(p_outs - ps) * in_w[..., None]).sum()
        energy = (torch.square(e_outs - es) * in_w[..., None]).sum()
    else:
        m = out_mask.float()
        denom = torch.clamp(m.sum() * ys.shape[2], min=1.0)
        l1 = ((torch.abs(before - ys) * m).sum() / denom
              + (torch.abs(after - ys) * m).sum() / denom)
        dur = duration_predictor_loss(d_outs, ds, in_mask)
        im = in_mask.float()[..., None]
        pitch = ((torch.square(p_outs - ps) * im).sum()
                 / torch.clamp(im.sum(), min=1.0))
        energy = ((torch.square(e_outs - es) * im).sum()
                  / torch.clamp(im.sum(), min=1.0))
    return {"loss": l1 + dur + pitch + energy, "l1_loss": l1,
            "duration_loss": dur, "pitch_loss": pitch,
            "energy_loss": energy}
