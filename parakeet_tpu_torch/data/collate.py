"""Collate functions (counterpart of ``parakeet_tpu/data/collate.py``).

Ported so far: ``VocoderClip``, the random aligned (wav, mel) window of
GAN-vocoder training.  It returns numpy arrays; the step moves them to
the card.
"""
from __future__ import annotations

import numpy as np

__all__ = ["VocoderClip"]


class VocoderClip:
    """Random aligned (wav, mel) window cropper for GAN-vocoder training.

    Same contract as the reference's Clip (reference:
    parakeet/datasets/vocoder_batch_fn.py:19-118): drops examples whose
    mel is not longer than the window, picks a random start frame honoring
    the generator's ``aux_context_window``, and returns fixed-size arrays.

    Unlike the JAX copy, whose default generator is unseeded, the start
    frames come from ``np.random.default_rng((seed, epoch))``: ``set_epoch``
    reseeds it (``DataLoader`` calls it at the start of every pass), so a
    run resumed at an epoch boundary draws the clips an uninterrupted run
    draws.

    Returns dict with ``wav`` (B, T) and ``mel`` (B, T', C) where
    T = batch_max_steps and T' = T // hop_size + 2 * aux_context_window.
    """

    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 aux_context_window: int = 0, *, seed: int):
        batch_max_steps -= batch_max_steps % hop_size
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.hop_size = hop_size
        self.aux_context_window = aux_context_window
        self.mel_threshold = self.batch_max_frames + 2 * aux_context_window
        self.seed = seed
        self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        self.rng = np.random.default_rng((self.seed, epoch))

    def _align(self, wav: np.ndarray, mel: np.ndarray):
        need = mel.shape[0] * self.hop_size
        if len(wav) < need:
            wav = np.pad(wav, (0, need - len(wav)), mode="edge")
        return wav[:need], mel

    def __call__(self, examples):
        pairs = [
            self._align(np.asarray(x["wave"], dtype=np.float32),
                        np.asarray(x["feats"], dtype=np.float32))
            for x in examples
            if np.asarray(x["feats"]).shape[0] > self.mel_threshold
        ]
        if not pairs:
            raise ValueError(
                f"no clip longer than {self.mel_threshold} mel frames")
        wavs, mels = [], []
        for wav, mel in pairs:
            hi = mel.shape[0] - self.batch_max_frames - self.aux_context_window
            start = int(self.rng.integers(self.aux_context_window, hi + 1))
            wavs.append(wav[start * self.hop_size:
                            start * self.hop_size + self.batch_max_steps])
            mels.append(mel[start - self.aux_context_window:
                            start + self.batch_max_frames
                            + self.aux_context_window])
        return {"wav": np.stack(wavs), "mel": np.stack(mels)}
