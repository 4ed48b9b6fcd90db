"""Collate functions (counterpart of ``parakeet_tpu/data/collate.py``).

Ported so far: ``fastspeech2_batch_fn``, ``speedyspeech_batch_fn`` and
``transformer_tts_batch_fn``, the acoustic models' padded batches, and
``VocoderClip``, the random aligned (wav, mel) window of GAN-vocoder
training.  They return numpy arrays; the step moves them to
the card.
"""
from __future__ import annotations

import numpy as np

from .batch import batch_sequences, bucket_length

__all__ = ["fastspeech2_batch_fn", "speedyspeech_batch_fn",
           "transformer_tts_batch_fn", "VocoderClip"]


def _lens(items, key) -> np.ndarray:
    return np.array([np.asarray(x[key]).shape[0] for x in items],
                    dtype=np.int64)


def _padded(examples, key, dtype, length) -> np.ndarray:
    return batch_sequences([np.asarray(x[key], dtype=dtype)
                            for x in examples], length=length)


def fastspeech2_batch_fn(examples, spk: bool = False,
                         text_bucket: int = 16, frame_bucket: int = 64):
    """FastSpeech2 training batch (single or multi speaker).

    fields: text, speech (T, odim), durations, pitch (L, 1), energy (L, 1)
    [, spk_id] [, spk_emb]; adds text_lengths / speech_lengths.  The text
    axis pads to a multiple of ``text_bucket``, the frame axis to one of
    ``frame_bucket``, with zeros.
    """
    if not examples:
        raise ValueError("collate called with an empty example list")
    text_len = bucket_length(
        max(len(np.asarray(x["text"])) for x in examples), text_bucket)
    frame_len = bucket_length(
        max(np.asarray(x["speech"]).shape[0] for x in examples), frame_bucket)

    batch = {
        "text": _padded(examples, "text", np.int64, text_len),
        "text_lengths": _lens(examples, "text"),
        "speech": _padded(examples, "speech", np.float32, frame_len),
        "speech_lengths": _lens(examples, "speech"),
        "durations": _padded(examples, "durations", np.int64, text_len),
        "pitch": _padded(examples, "pitch", np.float32, text_len),
        "energy": _padded(examples, "energy", np.float32, text_len),
    }
    if spk:
        batch["spk_id"] = np.array(
            [int(x["spk_id"]) for x in examples], dtype=np.int64)
    if "spk_emb" in examples[0]:
        batch["spk_emb"] = np.stack(
            [np.asarray(x["spk_emb"], dtype=np.float32) for x in examples])
    return batch


def speedyspeech_batch_fn(examples, text_bucket: int = 16,
                          frame_bucket: int = 64):
    """SpeedySpeech training batch: phones, tones and durations padded to
    a multiple of ``text_bucket``, feats (T, n_mels) to one of
    ``frame_bucket``, with zeros; num_phones and num_frames."""
    if not examples:
        raise ValueError("collate called with an empty example list")
    text_len = bucket_length(
        max(len(np.asarray(x["phones"])) for x in examples), text_bucket)
    frame_len = bucket_length(
        max(np.asarray(x["feats"]).shape[0] for x in examples), frame_bucket)
    return {
        "phones": _padded(examples, "phones", np.int64, text_len),
        "tones": _padded(examples, "tones", np.int64, text_len),
        "num_phones": _lens(examples, "phones"),
        "num_frames": _lens(examples, "feats"),
        "feats": _padded(examples, "feats", np.float32, frame_len),
        "durations": _padded(examples, "durations", np.int64, text_len),
    }


def transformer_tts_batch_fn(examples, text_bucket: int = 16,
                             frame_bucket: int = 64):
    """TransformerTTS batch: text padded to a multiple of ``text_bucket``,
    speech (T, n_mels) to one of ``frame_bucket``, with zeros;
    text_lengths and speech_lengths.  The JAX package's Tacotron2 batch
    function is this one; the Tacotron2 recipe adds ``spk_emb`` to it
    (``recipes/tacotron2/train.py``)."""
    if not examples:
        raise ValueError("collate called with an empty example list")
    text_len = bucket_length(
        max(len(np.asarray(x["text"])) for x in examples), text_bucket)
    frame_len = bucket_length(
        max(np.asarray(x["speech"]).shape[0] for x in examples), frame_bucket)
    return {
        "text": _padded(examples, "text", np.int64, text_len),
        "text_lengths": _lens(examples, "text"),
        "speech": _padded(examples, "speech", np.float32, frame_len),
        "speech_lengths": _lens(examples, "speech"),
    }


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
