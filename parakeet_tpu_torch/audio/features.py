"""Preprocess-time feature extractors (host side, numpy) of the port: a
copy of ``parakeet_tpu/audio/features.py``.

Equivalents of the reference's LogMelFBank / Pitch / Energy extractors
(reference: parakeet/data/get_feats.py:20,91,167) with the same defaults,
output layouts, and token-averaging semantics.  Pitch tracking is a
self-contained YIN implementation (de Cheveigné & Kawahara 2002) standing in
for pyworld's dio+stonemask, with the same post-processing: continuous-f0
linear interpolation, log domain, duration-averaged tokens.
"""
from __future__ import annotations

import functools

import numpy as np

from .spectrum import frame_signal, mel_filterbank, stft

__all__ = ["LogMelFBank", "Pitch", "Energy", "average_by_duration",
           "cached_extractors"]


class LogMelFBank:
    """wav -> log-mel spectrogram, shape (n_frames, n_mels).

    Defaults match the reference's CSMSC/baker configuration
    (parakeet/data/get_feats.py:21-30): 24 kHz, n_fft 2048, hop 300,
    mel 80 bands in [80, 7600] Hz, log base 10.
    """

    def __init__(self,
                 sr: int = 24000,
                 n_fft: int = 2048,
                 hop_length: int = 300,
                 win_length: int | None = None,
                 window: str = "hann",
                 n_mels: int = 80,
                 fmin: float | None = 80,
                 fmax: float | None = 7600,
                 eps: float = 1e-10):
        self.sr = sr
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window
        self.n_mels = n_mels
        self.fmin = 0.0 if fmin is None else fmin
        self.fmax = sr / 2 if fmax is None else fmax
        self.eps = eps
        self.mel_filter = mel_filterbank(
            sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=self.fmin, fmax=self.fmax)

    def _magnitude(self, wav: np.ndarray) -> np.ndarray:
        return np.abs(
            stft(wav,
                 n_fft=self.n_fft,
                 hop_length=self.hop_length,
                 win_length=self.win_length,
                 window=self.window))

    def get_mel_spectrogram(self, wav: np.ndarray) -> np.ndarray:
        """(n_mels, n_frames) linear mel spectrogram."""
        return self.mel_filter @ self._magnitude(wav)

    def get_log_mel_fbank(self, wav: np.ndarray, base: str = "10"
                          ) -> np.ndarray:
        """(n_frames, n_mels) log mel; base '10' (TTS) or 'e' (ASR)."""
        mel = np.clip(self.get_mel_spectrogram(wav), self.eps, None).T
        if base == "10":
            return np.log10(mel).astype(np.float32)
        elif base == "e":
            return np.log(mel).astype(np.float32)
        raise ValueError(f"unsupported log base: {base!r}")

    # convenience alias
    __call__ = get_log_mel_fbank


def average_by_duration(values: np.ndarray, durations: np.ndarray
                        ) -> np.ndarray:
    """Mean of frame-level ``values`` within each token's duration span.

    Returns shape (n_tokens, 1), matching the reference's token-averaged
    pitch/energy targets (parakeet/data/get_feats.py:141-153).  Empty spans
    (zero duration) produce 0.
    """
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    edges = np.concatenate([[0], np.cumsum(durations)]).astype(np.int64)
    out = np.zeros(len(durations), dtype=np.float64)
    for i, (s, e) in enumerate(zip(edges[:-1], edges[1:])):
        seg = values[s:e]
        if seg.size:
            out[i] = seg.mean()
    return out[:, None].astype(np.float32)


class Pitch:
    """Frame-level fundamental-frequency extractor.

    Same interface/post-processing as the reference's pyworld-based Pitch
    (parakeet/data/get_feats.py:91-164): frames every ``hop_length`` samples,
    0 marks unvoiced; options for continuous interpolation, log-f0, and
    token averaging by duration.

    ``method``: "auto" uses pyworld's dio+stonemask (the reference's
    exact estimator) when the optional pyworld package is installed and
    falls back to the self-contained YIN implementation otherwise;
    "world" requires pyworld; "yin" forces the fallback.
    """

    def __init__(self,
                 sr: int = 24000,
                 hop_length: int = 300,
                 f0min: float = 80,
                 f0max: float = 7600,
                 threshold: float = 0.15,
                 method: str = "auto"):
        if method not in ("auto", "world", "yin"):
            raise ValueError(f"unknown pitch method {method!r}")
        self._pyworld = None
        if method in ("auto", "world"):
            try:
                import pyworld
                self._pyworld = pyworld
            except ImportError:
                if method == "world":
                    raise
        self.sr = sr
        self.hop_length = hop_length
        self.f0min = max(f0min, 1.0)
        # YIN can't see periods shorter than 2 samples / longer than frame
        self.f0max = min(f0max, sr / 4)
        self.threshold = threshold
        # window must cover >= 2 periods of the lowest expected pitch
        self.frame_length = int(2 ** np.ceil(np.log2(2.5 * sr / self.f0min)))

    def _yin_f0(self, wav: np.ndarray) -> np.ndarray:
        """Raw per-frame f0 in Hz; 0 = unvoiced."""
        x = np.asarray(wav, dtype=np.float64)
        fl, hop = self.frame_length, self.hop_length
        tau_min = max(2, int(self.sr / self.f0max))
        tau_max = min(fl // 2, int(np.ceil(self.sr / self.f0min)) + 1)

        frames = frame_signal(x, fl, hop, center=True, pad_mode="constant")
        n_frames, _ = frames.shape
        w = fl // 2  # correlation window

        # difference function d(tau) = sum_{j<w} (x_j - x_{j+tau})^2
        #   = e_head + e_tau - 2 c(tau)
        # with c(tau) = sum_{j<w} x_j x_{j+tau} computed via FFT
        # cross-correlation of the head window against the whole frame.
        fsize = 2 * fl
        head = frames[:, :w]
        fa = np.fft.rfft(frames, fsize, axis=1)
        fb = np.fft.rfft(head, fsize, axis=1)
        xcorr = np.fft.irfft(fa * np.conj(fb), fsize, axis=1)[:, :tau_max + 1]
        # energy of x[tau : tau + w] for each tau
        sq = frames ** 2
        csum = np.concatenate(
            [np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)], axis=1)
        taus = np.arange(tau_max + 1)
        e_tau = csum[:, taus + w] - csum[:, taus]          # (n, tau_max+1)
        e_head = e_tau[:, :1]
        d = e_head + e_tau - 2 * xcorr
        d = np.maximum(d, 0.0)

        # cumulative-mean-normalized difference
        cum = np.cumsum(d[:, 1:], axis=1)
        cmndf = np.ones_like(d)
        with np.errstate(divide="ignore", invalid="ignore"):
            cmndf[:, 1:] = d[:, 1:] * taus[1:][None, :] / np.maximum(
                cum, 1e-12)

        band = cmndf[:, tau_min:tau_max]
        # first tau under threshold, then descend to the bottom of that dip
        # (de Cheveigné & Kawahara 2002, step 4); fall back to global argmin.
        under = band < self.threshold
        first = np.argmax(under, axis=1) + tau_min
        has_under = under.any(axis=1)
        # a "dip bottom" at tau: cmndf stops decreasing at tau+1
        bottom = np.concatenate(
            [cmndf[:, 1:] > cmndf[:, :-1],
             np.ones((n_frames, 1), dtype=bool)], axis=1)
        candidates = bottom & (taus[None, :] >= first[:, None])
        descent_end = np.argmax(candidates, axis=1)
        descent_end = np.where(candidates.any(axis=1), descent_end,
                               tau_max - 1)
        best = np.where(has_under,
                        np.minimum(descent_end, tau_max - 1),
                        np.argmin(band, axis=1) + tau_min)

        # parabolic interpolation around the minimum
        b = np.clip(best, tau_min + 1, tau_max - 1)
        y0 = cmndf[np.arange(n_frames), b - 1]
        y1 = cmndf[np.arange(n_frames), b]
        y2 = cmndf[np.arange(n_frames), b + 1]
        denom = y0 - 2 * y1 + y2
        shift = np.where(np.abs(denom) > 1e-12,
                         0.5 * (y0 - y2) / np.maximum(np.abs(denom), 1e-12)
                         * np.sign(denom) ** 2, 0.0)
        shift = np.clip(shift, -1.0, 1.0)
        tau = b.astype(np.float64) + np.where(b == best, shift, 0.0)

        f0 = self.sr / np.maximum(tau, 1e-6)
        dip = cmndf[np.arange(n_frames), best]
        frame_rms = np.sqrt(np.mean(frames ** 2, axis=1))
        voiced = (dip < max(self.threshold * 2.5, 0.35)) \
            & (frame_rms > 1e-4) \
            & (f0 >= self.f0min) & (f0 <= self.f0max)
        return np.where(voiced, f0, 0.0)

    @staticmethod
    def _continuous_f0(f0: np.ndarray) -> np.ndarray:
        """Linearly interpolate through unvoiced gaps; edge-hold."""
        f0 = f0.copy()
        nz = np.flatnonzero(f0 != 0)
        if nz.size == 0:
            return f0
        f0[:nz[0]] = f0[nz[0]]
        f0[nz[-1]:] = f0[nz[-1]]
        nz = np.flatnonzero(f0 != 0)
        idx = np.arange(len(f0))
        return np.interp(idx, nz, f0[nz])

    def _world_f0(self, wav: np.ndarray) -> np.ndarray:
        """pyworld dio + stonemask, exactly the reference estimator
        (get_feats.py:121-137)."""
        x = np.ascontiguousarray(wav, dtype=np.float64)
        frame_period = 1000.0 * self.hop_length / self.sr
        f0, timeaxis = self._pyworld.dio(
            x, fs=self.sr, f0_floor=self.f0min, f0_ceil=self.f0max,
            frame_period=frame_period)
        return self._pyworld.stonemask(x, f0, timeaxis, self.sr)

    def get_pitch(self,
                  wav: np.ndarray,
                  use_continuous_f0: bool = True,
                  use_log_f0: bool = True,
                  use_token_averaged_f0: bool = True,
                  duration: np.ndarray | None = None) -> np.ndarray:
        f0 = (self._world_f0(wav) if self._pyworld is not None
              else self._yin_f0(wav))
        if use_continuous_f0:
            f0 = self._continuous_f0(f0)
        if use_log_f0:
            nz = f0 != 0
            f0 = np.where(nz, np.log(np.maximum(f0, 1e-10)), 0.0)
        if use_token_averaged_f0 and duration is not None:
            return average_by_duration(f0, duration)
        return f0.astype(np.float32)

    __call__ = get_pitch


class Energy:
    """Frame-level energy: sqrt of summed STFT power per frame.

    Matches the reference's Energy extractor
    (parakeet/data/get_feats.py:167-220).
    """

    def __init__(self,
                 sr: int = 24000,
                 n_fft: int = 2048,
                 hop_length: int = 300,
                 win_length: int | None = None,
                 window: str = "hann",
                 center: bool = True,
                 pad_mode: str = "reflect"):
        self.sr = sr
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window
        self.center = center
        self.pad_mode = pad_mode

    def get_energy(self,
                   wav: np.ndarray,
                   use_token_averaged_energy: bool = True,
                   duration: np.ndarray | None = None) -> np.ndarray:
        power = np.abs(
            stft(np.asarray(wav, dtype=np.float32),
                 n_fft=self.n_fft,
                 hop_length=self.hop_length,
                 win_length=self.win_length,
                 window=self.window,
                 center=self.center,
                 pad_mode=self.pad_mode)) ** 2
        energy = np.sqrt(np.clip(power.sum(axis=0), 1e-10, None))
        if use_token_averaged_energy and duration is not None:
            return average_by_duration(energy, duration)
        return energy.astype(np.float32)

    __call__ = get_energy


@functools.lru_cache(maxsize=8)
def cached_extractors(fs, n_fft, n_shift, win_length, fmin, fmax, n_mels,
                      f0min=None, f0max=None):
    """(LogMelFBank, Pitch | None, Energy) memoized per parameter set.

    Recipe preprocess CLIs fan out per-utterance jobs over a
    ProcessPoolExecutor; this gives each worker process one extractor
    set instead of rebuilding the mel filterbank per utterance.  Pitch
    is built only when f0min/f0max are given.
    """
    mel = LogMelFBank(sr=fs, n_fft=n_fft, hop_length=n_shift,
                      win_length=win_length, fmin=fmin, fmax=fmax,
                      n_mels=n_mels)
    pitch = (Pitch(sr=fs, hop_length=n_shift, f0min=f0min, f0max=f0max)
             if f0min is not None else None)
    energy = Energy(sr=fs, n_fft=n_fft, hop_length=n_shift,
                    win_length=win_length)
    return mel, pitch, energy
