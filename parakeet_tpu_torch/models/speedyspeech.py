"""SpeedySpeech (counterpart of ``parakeet_tpu/models/speedyspeech.py``;
reference: parakeet/models/speedyspeech/speedyspeech.py:20-232): a
pure-convolution, non-autoregressive text -> mel model.

Phone (+ tone) embedding -> prenet -> dilated residual convolutions
(each block n x [conv -> ReLU -> BatchNorm] plus its input) -> linear
postnet -> duration predictor on the detached encodings (log domain,
kernels 4 / 3 / 1) -> expansion by durations (``length_regulate``) ->
sinusoidal positions -> dilated residual decoder -> mel.  Submodules keep
the flax names, so ``bridge.py`` loads a JAX checkpoint leaf for leaf.

As in flax, ``deterministic`` (default True) selects BatchNorm's running
statistics; ``deterministic=False`` normalizes with the batch's and
updates the running ones (momentum 0.99, biased variance, float32).  The
compute dtype is the parameters' dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.conv import SameConv1d
from ..nn.postnet import _BN_EPS, flax_batch_norm
from ..ops.length_regulator import length_regulate
from ..ops.losses import masked_l1_loss, weighted_mean
from ..ops.masking import sequence_mask
from ..ops.positional import sinusoid_position_encoding
from ..ops.ssim import ssim

__all__ = ["SpeedySpeech", "speedyspeech_loss"]

ENCODER_DILATIONS = (1, 3, 9, 27, 1, 3, 9, 27, 1, 1)
DECODER_DILATIONS = (1, 3, 9, 27, 1, 3, 9, 27, 1, 3, 9, 27, 1, 3, 9, 27,
                     1, 1)


class ResidualBlock(nn.Module):
    """x + [dilated SAME conv -> ReLU -> BatchNorm] x n."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, n: int = 2):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv_{i}", SameConv1d(
                channels, channels, kernel_size, dilation=dilation))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(channels, eps=_BN_EPS))

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = torch.relu(getattr(self, f"conv_{i}")(h))
            h = flax_batch_norm(getattr(self, f"bn_{i}"), h,
                                deterministic=deterministic)
        return x + h


class TextEmbedding(nn.Module):
    """Phone embedding plus an optional tone embedding, added or
    concatenated.  The padding id's rows are zeroed by multiplying with
    the mask (as the JAX module does), so a loaded table whose padding row
    is not zero gives the same result."""

    def __init__(self, vocab_size: int, embed_size: int,
                 tone_vocab_size: Optional[int] = None,
                 tone_embed_size: Optional[int] = None,
                 concat: bool = False, padding_idx: int = 0):
        super().__init__()
        self.concat, self.padding_idx = concat, padding_idx
        self.text_embed = nn.Embedding(vocab_size, embed_size)
        if tone_vocab_size is not None:
            self.tone_embed = nn.Embedding(tone_vocab_size,
                                           tone_embed_size or embed_size)

    def _masked(self, table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        emb = table(ids)
        return emb * (ids != self.padding_idx)[..., None].to(emb.dtype)

    def forward(self, text: torch.Tensor,
                tones: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self._masked(self.text_embed, text)
        if tones is not None and hasattr(self, "tone_embed"):
            tone = self._masked(self.tone_embed, tones)
            emb = torch.cat([emb, tone], -1) if self.concat else emb + tone
        return emb


class SpeedySpeechEncoder(nn.Module):
    """prenet -> residual dilated convolutions -> embedding-residual linear
    postnet -> ReLU -> BatchNorm -> linear."""

    def __init__(self, hidden_size: int = 128, kernel_size: int = 3,
                 dilations: Sequence[int] = ENCODER_DILATIONS):
        super().__init__()
        self.n_blocks = len(dilations)
        self.prenet_fc = nn.Linear(hidden_size, hidden_size)
        for i, d in enumerate(dilations):
            self.add_module(f"res_{i}", ResidualBlock(hidden_size,
                                                      kernel_size, d, n=2))
        self.postnet1_fc = nn.Linear(hidden_size, hidden_size)
        self.postnet2_bn = nn.BatchNorm1d(hidden_size, eps=_BN_EPS)
        self.postnet2_fc = nn.Linear(hidden_size, hidden_size)

    def forward(self, emb: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        emb = torch.relu(self.prenet_fc(emb))
        h = emb
        for i in range(self.n_blocks):
            h = getattr(self, f"res_{i}")(h, deterministic=deterministic)
        x = torch.relu(emb + self.postnet1_fc(h))
        x = flax_batch_norm(self.postnet2_bn, x, deterministic=deterministic)
        return self.postnet2_fc(x)


class SSDurationPredictor(nn.Module):
    """Residual blocks of one sub-block each, kernels 4 / 3 / 1, then a
    linear head: log-domain durations (B, T)."""

    def __init__(self, hidden_size: int = 128):
        super().__init__()
        for i, k in enumerate((4, 3, 1)):
            self.add_module(f"res_{i}", ResidualBlock(hidden_size, k, 1, n=1))
        self.fc = nn.Linear(hidden_size, 1)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        h = x
        for i in range(3):
            h = getattr(self, f"res_{i}")(h, deterministic=deterministic)
        return self.fc(h)[..., 0]


class SpeedySpeechDecoder(nn.Module):
    """Residual dilated convolutions -> input-residual linear postnet ->
    residual block -> mel projection."""

    def __init__(self, hidden_size: int = 128, output_size: int = 80,
                 kernel_size: int = 3,
                 dilations: Sequence[int] = DECODER_DILATIONS):
        super().__init__()
        self.n_blocks = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"res_{i}", ResidualBlock(hidden_size,
                                                      kernel_size, d, n=2))
        self.postnet1_fc = nn.Linear(hidden_size, hidden_size)
        self.postnet2_res = ResidualBlock(hidden_size, kernel_size, 1, n=2)
        self.fc = nn.Linear(hidden_size, output_size)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        h = x
        for i in range(self.n_blocks):
            h = getattr(self, f"res_{i}")(h, deterministic=deterministic)
        x = x + self.postnet1_fc(h)
        x = self.postnet2_res(x, deterministic=deterministic)
        return self.fc(x)


class SpeedySpeech(nn.Module):
    """Constructor arguments keep the JAX module's (and the recipe YAML's)
    names.  ``spk_num`` adds a speaker embedding to the text embedding."""

    def __init__(self, vocab_size: int, encoder_hidden_size: int = 128,
                 encoder_kernel_size: int = 3,
                 encoder_dilations: Sequence[int] = ENCODER_DILATIONS,
                 duration_predictor_hidden_size: int = 128,
                 decoder_hidden_size: int = 128,
                 decoder_output_size: int = 80,
                 decoder_kernel_size: int = 3,
                 decoder_dilations: Sequence[int] = DECODER_DILATIONS,
                 tone_size: Optional[int] = None,
                 spk_num: Optional[int] = None, padding_idx: int = 0):
        super().__init__()
        self.embedding = TextEmbedding(vocab_size, encoder_hidden_size,
                                       tone_size, padding_idx=padding_idx)
        if spk_num is not None:
            self.spk_emb = nn.Embedding(spk_num, encoder_hidden_size)
        self.encoder = SpeedySpeechEncoder(
            encoder_hidden_size, encoder_kernel_size, encoder_dilations)
        self.duration_predictor = SSDurationPredictor(
            duration_predictor_hidden_size)
        self.decoder = SpeedySpeechDecoder(
            decoder_hidden_size, decoder_output_size, decoder_kernel_size,
            decoder_dilations)

    def encode(self, text, tones=None, spk_id=None, *,
               deterministic: bool = True):
        """(encodings (B, T, C), log durations (B, T)); the duration head
        sees the encodings detached."""
        emb = self.embedding(text, tones)
        if hasattr(self, "spk_emb") and spk_id is not None:
            emb = emb + self.spk_emb(spk_id)[:, None, :]
        encodings = self.encoder(emb, deterministic=deterministic)
        log_d = self.duration_predictor(encodings.detach(),
                                        deterministic=deterministic)
        return encodings, log_d

    def decode(self, expanded: torch.Tensor, *,
               deterministic: bool = True) -> torch.Tensor:
        pe = sinusoid_position_encoding(expanded.shape[1],
                                        expanded.shape[-1],
                                        dtype=expanded.dtype,
                                        device=expanded.device)
        return self.decoder(expanded + pe[None], deterministic=deterministic)

    def forward(self, text: torch.Tensor, durations: torch.Tensor,
                tones=None, spk_id=None, max_frames: Optional[int] = None,
                *, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """Teacher-forced: expanded by the given durations to
        ``max_frames`` (default: the longest total, a host read).
        Returns mel (B, max_frames, odim), log_durations (B, T) and
        frame_lengths (B,)."""
        encodings, log_d = self.encode(text, tones, spk_id,
                                       deterministic=deterministic)
        t_frames = max_frames or int(durations.sum(-1).max())
        expanded, frame_lengths = length_regulate(encodings, durations,
                                                  t_frames)
        mel = self.decode(expanded, deterministic=deterministic)
        return {"mel": mel, "log_durations": log_d,
                "frame_lengths": frame_lengths}

    def inference(self, text: torch.Tensor, tones=None, spk_id=None,
                  max_frames: int = 1000, alpha: float = 1.0, *,
                  deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """Free-running: expanded by round(alpha exp(log_d)) (half to
        even), clamped to [0, max_frames] and cast to int32, to a static
        ``max_frames``; no host read, so it may be captured."""
        encodings, log_d = self.encode(text, tones, spk_id,
                                       deterministic=deterministic)
        d = torch.clamp(torch.round(alpha * torch.exp(log_d)), 0,
                        max_frames).to(torch.int32)
        expanded, frame_lengths = length_regulate(encodings, d, max_frames)
        mel = self.decode(expanded, deterministic=deterministic)
        return {"mel": mel, "frame_lengths": frame_lengths}


def _huber(err: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err,
                       delta * (a - 0.5 * delta))


def speedyspeech_loss(outputs: Dict[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], *,
                      ssim_weight: float = 1.0, mel_weight: float = 1.0,
                      duration_weight: float = 1.0
                      ) -> Dict[str, torch.Tensor]:
    """Masked L1 + (1 - SSIM of the masked mels) + Huber (delta 1) of the
    log durations against log(max(d, 1)) over the valid tokens.  Returns
    0-d tensors: loss, l1_loss, ssim_loss, duration_loss."""
    mel, target = outputs["mel"], batch["feats"]
    m3 = sequence_mask(batch["num_frames"], mel.shape[1]).to(
        mel.dtype)[..., None]
    l1 = masked_l1_loss(mel, target, m3.expand(mel.shape))
    ssim_loss = 1.0 - ssim((mel * m3)[:, None], (target * m3)[:, None])
    log_d = outputs["log_durations"]
    tok_mask = sequence_mask(batch["num_phones"], log_d.shape[1]).to(
        mel.dtype)
    log_d_target = torch.log(torch.clamp(batch["durations"].to(mel.dtype),
                                         min=1.0))
    dur_loss = weighted_mean(_huber(log_d - log_d_target), tok_mask)
    loss = (mel_weight * l1 + ssim_weight * ssim_loss
            + duration_weight * dur_loss)
    return {"loss": loss, "l1_loss": l1, "ssim_loss": ssim_loss,
            "duration_loss": dur_loss}
