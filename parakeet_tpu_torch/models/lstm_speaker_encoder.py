"""GE2E LSTM speaker encoder (counterpart of
``parakeet_tpu/models/lstm_speaker_encoder.py``; reference:
parakeet/models/lstm_speaker_encoder.py:24-147): a 3-layer LSTM over mel
frames -> linear -> ReLU -> L2-normalised embedding; the GE2E softmax loss
over an (N speakers x M utterances) similarity matrix against the
speakers' centroids, leave-one-out for the utterance's own speaker, with
a learnable scale (w, b).

Submodules keep the flax names: ``lstm_{i}`` holds its cell as ``cell``
(flax's ``nn.RNN`` around an ``OptimizedLSTMCell``), the projection is
``linear`` and the scale is two 0-d parameters at the root,
``similarity_weight`` (10) and ``similarity_bias`` (-5), so ``bridge.py``
loads a JAX checkpoint.  Each layer runs over every frame of the batch,
without lengths, as the JAX ``nn.RNN`` scan does
(``nn/rnn.py::lstm_sequence``: in float32 one ``torch.lstm`` call).  The norms are clamped at 1e-12
(``jnp.maximum(norm, 1e-12)``), not smoothed inside the square root.
``dtype`` is flax's (``nn/precision.py``): with ``torch.bfloat16`` the
LSTMs run flax's scan (``nn/rnn.py``: bf16 products and gates, the state
carried in float32, one step at a time), the projection, the embeddings
and the GE2E loss compute in bf16, and the scale (w, b) is created in
bf16, as the JAX module creates it in ``self.dtype``: those two are bf16
parameters, every other parameter float32.

``compute_eer`` and ``partial_slices`` are the JAX package's numpy and
Python, copied; ``embed_utterance`` cuts the same partial windows and
averages on the host in numpy as JAX does, with the partials embedded by
the module on its own device.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.precision import Dense
from ..nn.rnn import LSTMCell, lstm_sequence

__all__ = ["LSTMSpeakerEncoder", "ge2e_loss", "similarity_matrix",
           "scale_wb_gradients", "compute_eer", "partial_slices",
           "embed_utterance"]

_NORM_FLOOR = 1e-12
# the similarity scale's parameters, whose gradients the step scales
_WB_NAMES = ("similarity_weight", "similarity_bias")


class _RNN(nn.Module):
    """flax's ``nn.RNN`` around one LSTM cell named ``cell``."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm_sequence(self.cell, x)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12), the norm as ``jnp.linalg.norm`` computes it
    (in x's dtype, op by op)."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=_NORM_FLOOR)


class LSTMSpeakerEncoder(nn.Module):
    """Constructor arguments keep the JAX module's names."""

    def __init__(self, n_mels: int = 40, num_layers: int = 3,
                 hidden_size: int = 256, output_size: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", _RNN(
                n_mels if i == 0 else hidden_size, hidden_size, dtype))
        self.linear = Dense(hidden_size, output_size, dtype=dtype)
        scale_dtype = dtype or torch.float32
        self.similarity_weight = nn.Parameter(torch.tensor(
            10.0, dtype=scale_dtype))
        self.similarity_bias = nn.Parameter(torch.tensor(
            -5.0, dtype=scale_dtype))

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        """utterances (B, T, n_mels) -> L2-normalised embeddings (B, d)."""
        h = utterances
        for i in range(self.num_layers):
            h = getattr(self, f"lstm_{i}")(h)
        return _l2_normalize(torch.relu(self.linear(h[:, -1, :])))

    def embed_sequences(self, utterances: torch.Tensor, n_speakers: int
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
        """(N*M, T, n_mels) -> ((N, M, d) embeddings, (w, b))."""
        embeds = self(utterances)
        n_total, d = embeds.shape
        return (embeds.reshape(n_speakers, n_total // n_speakers, d),
                (self.similarity_weight, self.similarity_bias))


def similarity_matrix(embeds: torch.Tensor) -> torch.Tensor:
    """embeds (N, M, d) -> cosine similarities (N, M, N): sim[i, j, k] =
    cos(e_ij, centroid_k), with the own speaker's column (k = i) against
    the centroid of speaker i's other utterances."""
    n, m, _ = embeds.shape
    c_norm = _l2_normalize(embeds.mean(dim=1))                  # (N, d)
    sim = torch.einsum("ijd,kd->ijk", embeds, c_norm)
    excl = _l2_normalize((embeds.sum(dim=1, keepdim=True) - embeds)
                         / (m - 1))
    own = torch.einsum("ijd,ijd->ij", embeds, excl)             # (N, M)
    eye = torch.eye(n, dtype=embeds.dtype, device=embeds.device)
    return sim * (1 - eye)[:, None, :] + own[..., None] * eye[:, None, :]


def ge2e_loss(embeds: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """GE2E softmax loss of embeds (N, M, d) with the scale ReLU(w), b;
    returns (loss, {"loss", "accuracy", "sim"}), 0-d tensors but sim."""
    n, m, _ = embeds.shape
    sim = similarity_matrix(embeds) * torch.relu(w) + b
    logits = sim.reshape(n * m, n)
    labels = torch.arange(n, device=embeds.device).repeat_interleave(m)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp[torch.arange(n * m, device=embeds.device), labels].mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc, "sim": sim}


def scale_wb_gradients(model: LSTMSpeakerEncoder,
                       factor: float = 0.01) -> None:
    """Scale the gradients of the similarity scale (w, b) by ``factor``
    in place (reference ``do_gradient_ops``, :117), before the update."""
    for name in _WB_NAMES:
        grad = getattr(model, name).grad
        if grad is not None:
            grad.mul_(factor)


def compute_eer(sim: np.ndarray, n_speakers: int) -> float:
    """Equal error rate from an (N, M, N) similarity matrix, on the host
    (the JAX package's numpy, copied)."""
    sim = np.asarray(sim)
    n, m, _ = sim.shape
    labels = np.zeros((n, m, n), dtype=bool)
    labels[np.arange(n), :, np.arange(n)] = True
    scores = sim.reshape(-1)
    y = labels.reshape(-1)
    order = np.argsort(-scores)
    y_sorted = y[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(~y_sorted)
    fn = y.sum() - tp
    tn = (~y).sum() - fp
    fpr = fp / np.maximum(fp + tn, 1)
    fnr = fn / np.maximum(fn + tp, 1)
    idx = np.argmin(np.abs(fpr - fnr))
    return float((fpr[idx] + fnr[idx]) / 2)


def partial_slices(n_frames: int, partial_frames: int, hop: int):
    """Start indices of partial windows covering an utterance, with a
    tail window so that the last frames are embedded too."""
    if n_frames <= partial_frames:
        return [0]
    starts = list(range(0, n_frames - partial_frames + 1, hop))
    if starts[-1] + partial_frames < n_frames:
        starts.append(n_frames - partial_frames)
    return starts


@torch.no_grad()
def embed_utterance(model: LSTMSpeakerEncoder, mel, *,
                    partial_frames: int = 160, hop: int = 80,
                    embed_fn: Optional[Callable] = None) -> np.ndarray:
    """Utterance mel (T, n_mels) -> L2-normalised (d,) embedding: the
    mean over its overlapping partial windows (zero-padded to one window
    if shorter), each embedded by ``embed_fn`` (default: ``model``) on
    the model's device; shared by the GE2E exporter and the
    voice-cloning CLI."""
    mel = np.asarray(mel, np.float32)
    if mel.shape[0] < partial_frames:
        mel = np.pad(mel, ((0, partial_frames - mel.shape[0]), (0, 0)))
    starts = partial_slices(mel.shape[0], partial_frames, hop)
    partials = np.stack([mel[s:s + partial_frames] for s in starts])
    device = next(model.parameters()).device
    embeds = (embed_fn or model)(torch.from_numpy(partials).to(device))
    mean = embeds.float().cpu().numpy().mean(axis=0)
    return mean / max(np.linalg.norm(mean), 1e-12)
