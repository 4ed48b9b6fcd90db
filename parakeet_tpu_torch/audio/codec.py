"""Waveform IO and simple codecs (host side) of the port: a copy of
``parakeet_tpu/audio/codec.py``.

Replaces the reference's soundfile/librosa IO (parakeet/audio/audio.py:40-60)
with scipy.io.wavfile, plus the linear quantize/dequantize helpers
(parakeet/modules/audio.py:25-47) in numpy form.
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile

__all__ = ["load_wav", "save_wav", "quantize", "dequantize", "mu_law_encode",
           "mu_law_decode"]


def load_wav(path, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a wav file as float32 in [-1, 1]. Returns (wav, sample_rate).

    If ``sr`` is given and differs from the file's rate, the signal is
    resampled with polyphase filtering.
    """
    if str(path).lower().endswith(".wav"):
        file_sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            wav = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            wav = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            wav = (data.astype(np.float32) - 128.0) / 128.0
        else:
            wav = data.astype(np.float32)
    else:
        # flac/ogg/... need a codec library (optional dependency)
        try:
            import soundfile
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} requires the optional 'soundfile' "
                "package (only .wav decodes without it)") from e
        data, file_sr = soundfile.read(path, dtype="float32")
        wav = np.asarray(data, np.float32)
    if wav.ndim == 2:  # downmix
        wav = wav.mean(axis=1)
    if sr is not None and sr != file_sr:
        from scipy.signal import resample_poly
        from math import gcd
        g = gcd(sr, file_sr)
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return wav, file_sr


def save_wav(path, wav: np.ndarray, sr: int,
             volume_normalize: bool = False) -> None:
    """Write float waveform to 16-bit PCM wav.

    ``volume_normalize`` rescales peak to 0.999 like the reference's
    AudioProcessor (parakeet/audio/audio.py:52-58).
    """
    wav = np.asarray(wav, dtype=np.float32)
    if volume_normalize:
        peak = np.max(np.abs(wav))
        if peak > 0:
            wav = wav / peak * 0.999
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def quantize(values: np.ndarray, n_bands: int) -> np.ndarray:
    """Linearly quantize values in [-1, 1) into {0, ..., n_bands - 1}."""
    return ((values + 1.0) / 2.0 * n_bands).astype(np.int64).clip(
        0, n_bands - 1)


def dequantize(quantized: np.ndarray, n_bands: int,
               dtype=np.float32) -> np.ndarray:
    """Map {0, ..., n_bands-1} back to band centers in [-1, 1)."""
    return ((quantized.astype(dtype) + 0.5) / n_bands * 2.0 - 1.0)


def mu_law_encode(wav: np.ndarray, mu: int = 255) -> np.ndarray:
    """mu-law companding of float waveform in [-1, 1]."""
    wav = np.clip(wav, -1.0, 1.0)
    return np.sign(wav) * np.log1p(mu * np.abs(wav)) / np.log1p(mu)


def mu_law_decode(encoded: np.ndarray, mu: int = 255) -> np.ndarray:
    return np.sign(encoded) * (np.power(1 + mu, np.abs(encoded)) - 1) / mu
