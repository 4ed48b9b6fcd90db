"""Host-side (numpy) spectral analysis primitives of the port: a copy of
``parakeet_tpu/audio/spectrum.py`` (numpy and scipy only).

Self-contained replacements for the librosa routines the reference relies on
(reference: parakeet/data/get_feats.py:56-74, parakeet/audio/audio.py:40-99),
implemented from the standard definitions so preprocessing does not require
librosa.  Semantics are librosa-compatible:

- ``stft``: centered framing with reflect padding, periodic (fftbins) window
  zero-padded to ``n_fft``, one-sided complex output.
- ``mel_filterbank``: Slaney-style mel scale with Slaney area normalization
  (librosa defaults ``htk=False, norm='slaney'``).
"""
from __future__ import annotations

import numpy as np
from scipy import signal as _signal

__all__ = [
    "get_window",
    "stft",
    "istft",
    "spectrogram",
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "frame_signal",
    "inverse_mel",
    "griffin_lim",
    "logmel_to_wav",
]


def get_window(window, win_length: int) -> np.ndarray:
    """Periodic analysis window of ``win_length`` samples.

    ``window`` may be a name understood by scipy (e.g. ``"hann"``) or an
    array, which is passed through unchanged.
    """
    if isinstance(window, str):
        return _signal.get_window(window, win_length, fftbins=True).astype(
            np.float64)
    window = np.asarray(window)
    if len(window) != win_length:
        raise ValueError(
            f"window length {len(window)} != win_length {win_length}")
    return window


def _pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad ``window`` symmetrically to ``size`` samples."""
    n = len(window)
    if n > size:
        raise ValueError(f"window ({n}) longer than n_fft ({size})")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def frame_signal(x: np.ndarray, frame_length: int, hop_length: int,
                 center: bool = True, pad_mode: str = "reflect"
                 ) -> np.ndarray:
    """Slice ``x`` (1-D) into overlapping frames, shape (n_frames, frame_length)."""
    if center:
        x = np.pad(x, frame_length // 2, mode=pad_mode)
    n_frames = 1 + (len(x) - frame_length) // hop_length
    if n_frames < 1:
        raise ValueError(
            f"signal too short ({len(x)}) for frame_length {frame_length}")
    strides = (x.strides[0] * hop_length, x.strides[0])
    return np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, frame_length), strides=strides).copy()


def stft(x: np.ndarray,
         n_fft: int = 2048,
         hop_length: int | None = None,
         win_length: int | None = None,
         window="hann",
         center: bool = True,
         pad_mode: str = "reflect") -> np.ndarray:
    """Short-time Fourier transform of a 1-D signal.

    Returns a complex array of shape ``(1 + n_fft // 2, n_frames)`` matching
    librosa's layout so downstream mel code matches the reference
    (parakeet/data/get_feats.py:56-74) numerically.
    """
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    win = _pad_center(get_window(window, win_length), n_fft)
    frames = frame_signal(
        np.asarray(x, dtype=np.float64), n_fft, hop_length, center, pad_mode)
    spec = np.fft.rfft(frames * win[None, :], axis=-1)
    return spec.T


def istft(spec: np.ndarray,
          hop_length: int,
          win_length: int | None = None,
          window="hann",
          center: bool = True,
          length: int | None = None) -> np.ndarray:
    """Inverse STFT with overlap-add and window-envelope normalization."""
    n_fft = 2 * (spec.shape[0] - 1)
    if win_length is None:
        win_length = n_fft
    win = _pad_center(get_window(window, win_length), n_fft)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * win[None, :]
    n_frames = frames.shape[0]
    total = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    wsq = win ** 2
    for t in range(n_frames):
        s = t * hop_length
        out[s:s + n_fft] += frames[t]
        norm[s:s + n_fft] += wsq
    out = np.where(norm > 1e-10, out / np.maximum(norm, 1e-10), out)
    if center:
        out = out[n_fft // 2:]
    if length is not None:
        out = out[:length]
        if len(out) < length:
            out = np.pad(out, (0, length - len(out)))
    return out


def spectrogram(x: np.ndarray, power: float = 1.0, **kwargs) -> np.ndarray:
    """|STFT|**power, shape (1 + n_fft // 2, n_frames)."""
    return np.abs(stft(x, **kwargs)) ** power


# ---------------------------------------------------------------------------
# Mel scale (Slaney formulation, librosa-default)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3  # Hz per mel below the log knee
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mel, _MIN_LOG_MEL)
                                         - _MIN_LOG_MEL)),
        freq,
    )
    return freq


def mel_filterbank(sr: int,
                   n_fft: int,
                   n_mels: int = 80,
                   fmin: float = 0.0,
                   fmax: float | None = None,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.

    Slaney mel scale with optional Slaney area normalization — matches the
    filterbank the reference builds via librosa.filters.mel
    (parakeet/data/get_feats.py:47-54).
    """
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_edges = mel_to_hz(
        np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_edges)
    ramps = mel_edges[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_edges[2:n_mels + 2] - mel_edges[:n_mels])
        weights = weights * enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm!r}")
    return weights


def inverse_mel(mel: np.ndarray, sr: int, n_fft: int,
                fmin: float = 0.0, fmax: float | None = None,
                norm: str | None = "slaney") -> np.ndarray:
    """Approximate (n_mels, T) mel magnitudes -> (1 + n_fft//2, T) linear
    magnitudes via the filterbank pseudo-inverse (reference
    parakeet/audio/audio.py:52 inv_mel_filter)."""
    fb = mel_filterbank(sr, n_fft, mel.shape[0], fmin, fmax, norm)
    return np.maximum(np.linalg.pinv(fb) @ mel, 0.0)


def griffin_lim(magnitude: np.ndarray, hop_length: int,
                win_length: int | None = None, window="hann",
                n_iter: int = 32, momentum: float = 0.99,
                length: int | None = None, seed: int = 0) -> np.ndarray:
    """Phase reconstruction from a (1 + n_fft//2, T) magnitude
    spectrogram: iterate istft -> stft keeping the target magnitude,
    with fast-Griffin-Lim momentum extrapolation (Perraudin et al.).
    The vocoder-free synthesis fallback (the reference exposes the
    pieces — istft + inv_mel_filter — without the loop)."""
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(magnitude.shape))
    n_fft = 2 * (magnitude.shape[0] - 1)
    spec = magnitude.astype(np.complex128) * angles
    prev = None
    for _ in range(n_iter):
        c = spec if prev is None else spec + momentum * (spec - prev)
        prev = spec
        wav = istft(c, hop_length, win_length, window, length=length)
        rebuilt = stft(wav, n_fft=n_fft, hop_length=hop_length,
                       win_length=win_length, window=window)
        rebuilt = rebuilt[:, :magnitude.shape[1]]
        if rebuilt.shape[1] < magnitude.shape[1]:
            rebuilt = np.pad(
                rebuilt, ((0, 0), (0, magnitude.shape[1] - rebuilt.shape[1])))
        phase = rebuilt / np.maximum(np.abs(rebuilt), 1e-10)
        spec = magnitude * phase
    return istft(spec, hop_length, win_length, window, length=length)


def logmel_to_wav(logmel: np.ndarray, sr: int, n_fft: int,
                  hop_length: int, win_length: int | None = None,
                  fmin: float = 0.0, fmax: float | None = None,
                  base: str = "10", n_iter: int = 32,
                  window="hann") -> np.ndarray:
    """Vocoder-free synthesis: (T, n_mels) log-mel -> waveform via mel
    pseudo-inverse + fast Griffin-Lim.  ``base`` matches LogMelFBank
    ("10" or "e")."""
    mel = np.asarray(logmel, np.float64).T          # (n_mels, T)
    mag = np.power(10.0, mel) if base == "10" else np.exp(mel)
    lin = inverse_mel(mag, sr, n_fft, fmin, fmax)
    return griffin_lim(lin, hop_length, win_length, window,
                       n_iter=n_iter).astype(np.float32)
