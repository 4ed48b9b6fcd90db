"""Tacotron2 (counterpart of ``parakeet_tpu/models/tacotron2.py``;
reference: parakeet/models/tacotron2.py:82-982): an autoregressive
attention seq2seq text -> mel model.

Embedding (+ tone embedding, + global condition) -> convolutions and a
BiLSTM encoder -> a decoder step (prenet, attention LSTM,
location-sensitive attention, decoder LSTM, frame and stop projections)
run once per frame -> the 5-convolution Postnet residual.  Submodules keep
the flax names (the encoder's LSTMs are flax's ``OptimizedLSTMCell_0``,
forward, and ``_1``, backward), so ``bridge.py`` loads a JAX checkpoint.

- Teacher forcing runs the prenet over every step at once, outside the
  step loop, as the JAX ``__call__`` does.
- ``infer`` runs all ``max_decoder_steps`` with a ``finished`` flag per
  utterance, as the JAX scan does: the Postnet runs over the whole mel
  before the frames past each stop are zeroed, so the last valid frames
  depend on frames made after the stop, and an early exit would change
  them.  The prenet's always-on dropout masks of every step are drawn
  before the loop (or passed in), and the loop reads nothing back to the
  host, so the whole of ``infer`` may be captured in one CUDA graph.
- The attention weights and their running sum are carried in float32.

As in flax, ``deterministic`` (default True) turns off the encoder's,
attention's, decoder's and Postnet's dropout and selects BatchNorm's
running statistics; the prenet ignores it.  Every mask is drawn from the
``torch.Generator`` ``rng``.  ``dtype`` is flax's (``nn/precision.py``):
with ``torch.bfloat16`` the parameters stay float32, every layer computes
in bf16 where the JAX module does, and the decoder's carry (both LSTM
states and the context) is kept in bf16, as the JAX scan pins it, while
the attention weights and their sum stay float32.  The encoder's BiLSTM
runs flax's scan from a float32 carry (``nn/rnn.py``).  ``None`` computes
in the parameters' dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.attention import LocationSensitiveAttention
from ..nn.conv import SameConv1d
from ..nn.dropout import Dropout
from ..nn.initializer import init_flax_defaults_
from ..nn.postnet import _BN_EPS, Postnet, Prenet, flax_batch_norm
from ..nn.precision import (Dense, Embedding, casts_once, compute_dtype,
                            sigmoid)
from ..nn.rnn import LSTMCell, flip_sequences, lstm_sequence
from ..ops.losses import guided_attention_loss, stop_token_bce
from ..ops.masking import sequence_mask

__all__ = ["Tacotron2", "tacotron2_loss", "init_tacotron2_"]

# flax's auto-names of the encoder's two LSTM cells (forward, backward)
_LSTM_FWD, _LSTM_BWD = "OptimizedLSTMCell_0", "OptimizedLSTMCell_1"


class Tacotron2Encoder(nn.Module):
    """Convolutions (+ BatchNorm, ReLU, dropout) and a BiLSTM; the caller
    applies the embedding."""

    def __init__(self, d_encoder: int = 512, conv_layers: int = 3,
                 kernel_size: int = 5, dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_layers = conv_layers
        self.dropout = Dropout(dropout_rate)
        for i in range(conv_layers):
            self.add_module(f"conv_{i}", SameConv1d(
                d_encoder, d_encoder, kernel_size, bias=False, dtype=dtype))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(d_encoder, eps=_BN_EPS))
        half = d_encoder // 2
        self.add_module(_LSTM_FWD, LSTMCell(d_encoder, half, dtype))
        self.add_module(_LSTM_BWD, LSTMCell(d_encoder, half, dtype))

    def forward(self, x: torch.Tensor, input_mask: torch.Tensor, *,
                deterministic: bool = True, rng=None) -> torch.Tensor:
        """x (B, T, d_embed), input_mask (B, T) True at valid tokens ->
        (B, T, d_encoder): flax's values at every position (padding
        included; the decoder's attention masks it)."""
        h = x
        for i in range(self.conv_layers):
            h = getattr(self, f"conv_{i}")(h)
            h = flax_batch_norm(getattr(self, f"bn_{i}"), h,
                                deterministic=deterministic)
            h = self.dropout(torch.relu(h), deterministic=deterministic,
                             rng=rng)
        h = h * input_mask[..., None].to(h.dtype)
        lengths = input_mask.sum(-1)
        out_f = lstm_sequence(getattr(self, _LSTM_FWD), h)
        out_b = flip_sequences(lstm_sequence(
            getattr(self, _LSTM_BWD), flip_sequences(h, lengths)), lengths)
        return torch.cat([out_f, out_b], dim=-1)


Carry = Tuple[Tuple[torch.Tensor, torch.Tensor],
              Tuple[torch.Tensor, torch.Tensor],
              torch.Tensor, torch.Tensor, torch.Tensor]


class Tacotron2DecoderCell(nn.Module):
    """One decoder step: attention LSTM -> location-sensitive attention ->
    decoder LSTM -> frame and stop projections.

    Carry: ((h, c) of the attention LSTM, (h, c) of the decoder LSTM,
    context (B, d_v), attention weights (B, T) and their running sum
    (B, T), both float32).
    """

    def __init__(self, d_prenet: int, d_values: int, d_mels: int = 80,
                 reduction_factor: int = 1, d_attention_rnn: int = 1024,
                 d_decoder_rnn: int = 1024, d_attention: int = 128,
                 attention_filters: int = 32,
                 attention_kernel_size: int = 31,
                 p_attention_dropout: float = 0.1,
                 p_decoder_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attention_rnn = LSTMCell(d_prenet + d_values, d_attention_rnn,
                                      dtype)
        self.decoder_rnn = LSTMCell(d_attention_rnn + d_values,
                                    d_decoder_rnn, dtype)
        self.attention = LocationSensitiveAttention(
            d_attention_rnn, d_values, d_attention, attention_filters,
            attention_kernel_size, dtype)
        self.frame_proj = Dense(d_decoder_rnn + d_values,
                                d_mels * reduction_factor, dtype=dtype)
        self.stop_proj = Dense(d_decoder_rnn + d_values, 1, dtype=dtype)
        self.attn_dropout = Dropout(p_attention_dropout)
        self.dec_dropout = Dropout(p_decoder_dropout)

    def initial_carry(self, values: torch.Tensor) -> Carry:
        b, t, d = values.shape
        dtype = compute_dtype(self.frame_proj.dtype, self.frame_proj.weight)
        like = values.new_empty((), dtype=dtype)
        weights = torch.zeros((b, t), dtype=torch.float32,
                              device=values.device)
        return (self.attention_rnn.zero_state(b, like),
                self.decoder_rnn.zero_state(b, like),
                torch.zeros((b, d), dtype=dtype, device=values.device),
                weights, weights.clone())

    def forward(self, carry: Carry, prenet_out: torch.Tensor,
                processed_keys: torch.Tensor, values: torch.Tensor,
                key_mask: torch.Tensor, *, deterministic: bool = True,
                rng=None):
        """Returns (new carry, (frame (B, r d_mels), stop logit (B,),
        weights (B, T) float32))."""
        attn_state, dec_state, context, weights, cum_weights = carry
        attn_state = self.attention_rnn(
            torch.cat([prenet_out, context], dim=-1), attn_state)
        attn_h = self.attn_dropout(attn_state[0],
                                   deterministic=deterministic, rng=rng)
        context, weights = self.attention(attn_h, processed_keys, values,
                                          weights, cum_weights, key_mask)
        weights = weights.float()
        cum_weights = cum_weights.float() + weights
        dec_state = self.decoder_rnn(torch.cat([attn_h, context], dim=-1),
                                     dec_state)
        dec_h = self.dec_dropout(dec_state[0], deterministic=deterministic,
                                 rng=rng)
        proj_in = torch.cat([dec_h, context], dim=-1)
        frame = self.frame_proj(proj_in)
        stop_logit = self.stop_proj(proj_in)[..., 0]
        return ((attn_state, dec_state, context, weights, cum_weights),
                (frame, stop_logit, weights))


class Tacotron2(nn.Module):
    """Constructor arguments keep the JAX module's (and the recipe YAML's)
    names."""

    def __init__(self, vocab_size: int, n_tones: Optional[int] = None,
                 d_mels: int = 80, d_encoder: int = 512,
                 encoder_conv_layers: int = 3, encoder_kernel_size: int = 5,
                 d_prenet: int = 256, d_attention_rnn: int = 1024,
                 d_decoder_rnn: int = 1024, attention_filters: int = 32,
                 attention_kernel_size: int = 31, d_attention: int = 128,
                 d_postnet: int = 512, postnet_kernel_size: int = 5,
                 postnet_conv_layers: int = 5, reduction_factor: int = 1,
                 p_encoder_dropout: float = 0.5,
                 p_prenet_dropout: float = 0.5,
                 p_attention_dropout: float = 0.1,
                 p_decoder_dropout: float = 0.1,
                 p_postnet_dropout: float = 0.5,
                 d_global_condition: Optional[int] = None,
                 use_stop_token: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_mels, self.reduction_factor = d_mels, reduction_factor
        self.use_stop_token = use_stop_token
        d_values = d_encoder + (d_global_condition or 0)
        self.embedding = Embedding(vocab_size, d_encoder, dtype)
        if n_tones is not None:
            self.embedding_tones = Embedding(n_tones, d_encoder, dtype)
        self.encoder = Tacotron2Encoder(d_encoder, encoder_conv_layers,
                                        encoder_kernel_size,
                                        p_encoder_dropout, dtype)
        # bias-free, reference tacotron2.py:58-59 (DecoderPreNet)
        self.prenet = Prenet(d_mels, 2, d_prenet, p_prenet_dropout,
                             always_dropout=True, use_bias=False,
                             dtype=dtype)
        self.cell = Tacotron2DecoderCell(
            d_prenet, d_values, d_mels, reduction_factor, d_attention_rnn,
            d_decoder_rnn, d_attention, attention_filters,
            attention_kernel_size, p_attention_dropout, p_decoder_dropout,
            dtype)
        self.postnet = Postnet(d_mels, postnet_conv_layers, d_postnet,
                               postnet_kernel_size, use_batch_norm=True,
                               dropout_rate=p_postnet_dropout, dtype=dtype)

    def encode(self, text, text_lengths, tones=None, global_condition=None,
               *, deterministic: bool = True, rng=None):
        """(values (B, T, d_v), key mask (B, T))."""
        mask = sequence_mask(text_lengths, text.shape[1])
        emb = self.embedding(text)
        if tones is not None:
            emb = emb + self.embedding_tones(tones)
        enc = self.encoder(emb, mask, deterministic=deterministic, rng=rng)
        if global_condition is not None:
            g = global_condition[:, None, :].expand(-1, enc.shape[1], -1)
            enc = torch.cat([enc, g.to(enc.dtype)], dim=-1)
        return enc, mask

    @casts_once
    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                mels: torch.Tensor, output_lengths: torch.Tensor,
                tones=None, global_condition=None, *,
                deterministic: bool = True, rng=None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced training forward: text (B, T_enc) ids, mels
        (B, T_dec, d_mels).  Returns mel_output, mel_outputs_postnet
        (B, T_dec, d_mels), stop_logits (B, steps) and alignments
        (B, steps, T_enc) float32."""
        kw = dict(deterministic=deterministic, rng=rng)
        values, key_mask = self.encode(text, text_lengths, tones,
                                       global_condition, **kw)
        b, r = text.shape[0], self.reduction_factor
        n_steps = mels.shape[1] // r
        # the last frame of each previous reduction group, a zero frame
        # first; the prenet over every step at once
        dec_in = mels[:, r - 1::r, :]
        dec_in = torch.cat([torch.zeros_like(dec_in[:, :1]),
                            dec_in[:, :-1]], dim=1)
        prenet_out = self.prenet(dec_in, **kw)
        processed_keys = self.cell.attention.process_keys(values)
        carry = self.cell.initial_carry(values)
        frames, stops, alignments = [], [], []
        for i in range(n_steps):
            carry, (frame, stop, w) = self.cell(
                carry, prenet_out[:, i], processed_keys, values, key_mask,
                **kw)
            frames.append(frame)
            stops.append(stop)
            alignments.append(w)
        mel_output = torch.stack(frames, 1).reshape(b, n_steps * r,
                                                    self.d_mels)
        return {"mel_output": mel_output,
                "mel_outputs_postnet": mel_output + self.postnet(
                    mel_output, **kw),
                "stop_logits": torch.stack(stops, 1),
                "alignments": torch.stack(alignments, 1)}

    def prenet_masks(self, batch: int, max_decoder_steps: int,
                     rng: torch.Generator, device) -> Optional[torch.Tensor]:
        """The prenet's keep-masks of every step of ``infer``, (layers,
        steps, B, d_prenet), drawn from ``rng``; None when it drops
        nothing."""
        if not self.prenet.drops(True):
            return None
        return self.prenet.keep_masks((max_decoder_steps, batch), rng,
                                      device)

    @casts_once
    def infer(self, text: torch.Tensor, text_lengths: torch.Tensor,
              tones=None, global_condition=None,
              max_decoder_steps: int = 1000, stop_threshold: float = 0.5,
              grace_steps: int = 20, *, deterministic: bool = True,
              rng=None, prenet_keep=None) -> Dict[str, torch.Tensor]:
        """Free-running inference over exactly ``max_decoder_steps``.

        An utterance finishes once sigmoid(stop logit) > threshold (with
        ``use_stop_token``), else ``grace_steps`` steps after its attention
        peak reaches its last token; each step emits while the utterance
        had not finished before it.  ``prenet_keep`` (``prenet_masks``)
        holds the prenet's masks, else they are drawn from ``rng`` before
        the loop.  Returns mel_outputs_postnet (B, steps r, d_mels), zero
        past each utterance's frames, lengths (B,) and alignments
        (B, steps, T_enc).
        """
        kw = dict(deterministic=deterministic, rng=rng)
        values, key_mask = self.encode(text, text_lengths, tones,
                                       global_condition, **kw)
        b, r, d = text.shape[0], self.reduction_factor, self.d_mels
        if prenet_keep is None:
            prenet_keep = self.prenet_masks(b, max_decoder_steps, rng,
                                            values.device)
        processed_keys = self.cell.attention.process_keys(values)
        carry = self.cell.initial_carry(values)
        prev = torch.zeros((b, d), dtype=carry[2].dtype,
                           device=values.device)
        finished = torch.zeros((b,), dtype=torch.bool, device=values.device)
        counter = torch.zeros((b,), dtype=torch.int32, device=values.device)
        frames, alignments, valid = [], [], []
        for i in range(max_decoder_steps):
            p = self.prenet(prev, keep=None if prenet_keep is None
                            else prenet_keep[:, i], **kw)
            carry, (frame, stop, w) = self.cell(
                carry, p, processed_keys, values, key_mask, **kw)
            prev = frame.reshape(b, r, d)[:, -1, :]
            valid.append(~finished)
            if self.use_stop_token:
                finished = finished | (sigmoid(stop) > stop_threshold)
            else:
                hit = w.argmax(-1) >= (text_lengths - 1)
                counter = counter + hit.to(torch.int32)
                finished = finished | (counter > grace_steps)
            frames.append(frame)
            alignments.append(w)
        mel = torch.stack(frames, 1).reshape(b, max_decoder_steps * r, d)
        mel = mel + self.postnet(mel, **kw)
        valid_frames = torch.stack(valid, 1).repeat_interleave(r, dim=1)
        mel = mel * valid_frames[..., None].to(mel.dtype)
        return {"mel_outputs_postnet": mel,
                "lengths": valid_frames.sum(1, dtype=torch.int32),
                "alignments": torch.stack(alignments, 1)}


@torch.no_grad()
def init_tacotron2_(model: Tacotron2, gen: torch.Generator) -> None:
    """flax's initializers for the JAX module, from ``gen``: the defaults
    (``init_flax_defaults_``: lecun-normal kernels, orthogonal recurrent
    kernels, zero biases, unit scales), with the text embedding uniform
    on [0, 0.1) and the tone embedding on [0, 0.06)."""
    init_flax_defaults_(model, gen)
    model.embedding.weight.uniform_(0.0, 0.1, generator=gen)
    if hasattr(model, "embedding_tones"):
        model.embedding_tones.weight.uniform_(0.0, 0.06, generator=gen)


def tacotron2_loss(outputs: Dict[str, torch.Tensor], mels: torch.Tensor,
                   output_lengths: torch.Tensor, text_lengths: torch.Tensor,
                   *, use_stop_token_loss: bool = True,
                   use_guided_attention_loss: bool = False,
                   sigma: float = 0.2, stop_pos_weight: float = 1.0
                   ) -> Dict[str, torch.Tensor]:
    """MSE and Postnet MSE over the valid frames, + the stop BCE with the
    label 1 at each utterance's last valid step (masked by its steps), +
    the guided-attention loss; returns 0-d tensors: mel_loss,
    postnet_mel_loss [, stop_loss] [, guided_attn_loss], loss."""
    t_dec = mels.shape[1]
    m3 = sequence_mask(output_lengths, t_dec).to(mels.dtype)[..., None]
    n_el = torch.clamp(m3.sum() * mels.shape[-1], min=1.0)
    mel_loss = (torch.square(outputs["mel_output"] - mels) * m3).sum() / n_el
    post_loss = (torch.square(outputs["mel_outputs_postnet"] - mels)
                 * m3).sum() / n_el
    losses = {"mel_loss": mel_loss, "postnet_mel_loss": post_loss}
    loss = mel_loss + post_loss
    if use_stop_token_loss:
        stop_logits = outputs["stop_logits"]
        n_steps = stop_logits.shape[1]
        r = t_dec // n_steps
        step_lengths = torch.div(output_lengths + r - 1, r,
                                 rounding_mode="floor")
        idx = torch.arange(n_steps, device=mels.device)[None, :]
        labels = (idx == (step_lengths - 1)[:, None]).to(stop_logits.dtype)
        step_mask = (idx < step_lengths[:, None]).to(stop_logits.dtype)
        losses["stop_loss"] = stop_token_bce(stop_logits, labels,
                                             mask=step_mask,
                                             pos_weight=stop_pos_weight)
        loss = loss + losses["stop_loss"]
    if use_guided_attention_loss:
        n_steps = outputs["alignments"].shape[1]
        r = t_dec // n_steps
        losses["guided_attn_loss"] = guided_attention_loss(
            outputs["alignments"],
            torch.div(output_lengths + r - 1, r, rounding_mode="floor"),
            text_lengths, sigma)
        loss = loss + losses["guided_attn_loss"]
    losses["loss"] = loss
    return losses
