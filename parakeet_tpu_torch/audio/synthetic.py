"""Source-filter (Klatt-style) synthetic speech for validation: a copy of
``parakeet_tpu/audio/synthetic.py`` for the port.

No recorded speech ships with this repo, so tests that need
*speech acoustics* — harmonic voiced segments with formant structure,
fricative noise, silences, a declining F0 contour with vibrato/jitter —
synthesize them here with a classic cascade-formant synthesizer
(Klatt 1980: Rosenberg glottal source -> cascade of second-order
formant resonators -> radiation).  Unlike a recorded clip, the
ground-truth per-frame F0 and voicing of these utterances are known
*exactly*, which is what the pitch-extractor validation needs
(reference extractor under test: the YIN fallback in
audio/features.py, standing in for pyworld dio+stonemask,
reference parakeet/data/get_feats.py:91-143).
"""
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import signal

__all__ = ["formant_utterance", "VOWEL_FORMANTS", "FRICATIVE_BANDS"]

# (F1, F2, F3) Hz — canonical adult-male vowel targets (Peterson &
# Barney 1952 ballpark); bandwidths below.
VOWEL_FORMANTS: Dict[str, Tuple[float, float, float]] = {
    "a": (730.0, 1090.0, 2440.0),
    "i": (270.0, 2290.0, 3010.0),
    "u": (300.0, 870.0, 2240.0),
    "e": (530.0, 1840.0, 2480.0),
    "o": (570.0, 840.0, 2410.0),
}
_BANDWIDTHS = (60.0, 90.0, 120.0)

# fricative noise band (low, high) Hz
FRICATIVE_BANDS: Dict[str, Tuple[float, float]] = {
    "s": (3500.0, 9000.0),
    "sh": (1800.0, 6500.0),
    "f": (1200.0, 8000.0),
    "h": (400.0, 2500.0),
}


def _rosenberg(phase: np.ndarray, open_q: float = 0.6,
               speed_q: float = 0.16) -> np.ndarray:
    """Rosenberg glottal pulse as a function of phase in [0, 1)."""
    rise = open_q - speed_q
    g = np.zeros_like(phase)
    m1 = phase < rise
    g[m1] = 0.5 * (1.0 - np.cos(np.pi * phase[m1] / rise))
    m2 = (phase >= rise) & (phase < open_q)
    g[m2] = np.cos(0.5 * np.pi * (phase[m2] - rise) / speed_q)
    return g


def _resonator_ba(freq: float, bw: float, sr: int):
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    b = np.array([1.0 - 2.0 * r * np.cos(theta) + r * r])
    return b, a


def formant_utterance(
    phones: Optional[Sequence[Tuple[str, float]]] = None,
    sr: int = 24000,
    hop_length: int = 300,
    f0_start: float = 180.0,
    f0_end: float = 110.0,
    vibrato_hz: float = 5.0,
    vibrato_cents: float = 30.0,
    jitter: float = 0.005,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Synthesize one speech-like utterance.

    ``phones``: sequence of (phone, seconds).  Vowels (keys of
    VOWEL_FORMANTS) are voiced; FRICATIVE_BANDS keys are unvoiced;
    "sil"/"sp" are silence.  Default: "sil a i s u e sh o sil".

    Returns dict with
      wav           float32 (n,) in [-1, 1], length trimmed to a
                    multiple of ``hop_length``
      f0            float64 (n_frames,) ground-truth F0 at frame
                    centers, 0 where unvoiced
      voiced        bool (n_frames,)
      durations     int64 (n_phones,) frames per phone (sums to
                    n_frames)
      phones        list of phone labels
    """
    if phones is None:
        phones = [("sil", 0.08), ("a", 0.22), ("i", 0.18), ("s", 0.12),
                  ("u", 0.20), ("e", 0.16), ("sh", 0.10), ("o", 0.22),
                  ("sil", 0.08)]
    rng = np.random.default_rng(seed)

    # per-phone sample counts, rounded to whole hops so durations are
    # exact frame counts (what the duration targets need)
    durations = np.array(
        [max(1, round(d * sr / hop_length)) for _, d in phones], np.int64)
    n_frames = int(durations.sum())
    n = n_frames * hop_length
    labels = [p for p, _ in phones]

    starts = np.concatenate([[0], np.cumsum(durations)[:-1]]) * hop_length
    ends = np.cumsum(durations) * hop_length

    voiced_mask = np.zeros(n, dtype=bool)
    for p, s, e in zip(labels, starts, ends):
        if p in VOWEL_FORMANTS:
            voiced_mask[s:e] = True

    # --- F0 contour: declination over the utterance + vibrato + jitter
    t = np.arange(n) / sr
    decl = f0_start + (f0_end - f0_start) * (t / t[-1])
    vib = 2.0 ** (vibrato_cents / 1200.0
                  * np.sin(2 * np.pi * vibrato_hz * t))
    f0_track = decl * vib
    # per-period jitter: smooth low-rate noise on log-f0
    slow = rng.standard_normal(max(2, int(t[-1] * 30) + 1))
    slow = np.interp(t, np.linspace(0, t[-1], slow.size), slow)
    f0_track = f0_track * 2.0 ** (jitter * slow)
    f0_track = np.where(voiced_mask, f0_track, 0.0)

    # --- glottal source (phase accumulation handles time-varying F0)
    phase = np.cumsum(f0_track / sr) % 1.0
    source = _rosenberg(phase) * voiced_mask
    # aspiration floor so voiced frames are not perfectly periodic
    source = source + 0.01 * rng.standard_normal(n) * voiced_mask

    wav = np.zeros(n)
    xfade = int(0.005 * sr)
    for p, s, e in zip(labels, starts, ends):
        s, e = int(s), int(e)
        seg_len = e - s
        env = np.ones(seg_len)
        ramp = np.linspace(0.0, 1.0, min(xfade, seg_len))
        env[:ramp.size] = ramp
        env[seg_len - ramp.size:] = ramp[::-1]
        if p in VOWEL_FORMANTS:
            # take a halo of source so the filters are warmed up
            halo = min(s, 4 * xfade)
            seg = source[s - halo:e]
            for (freq, bw) in zip(VOWEL_FORMANTS[p], _BANDWIDTHS):
                b, a = _resonator_ba(freq, bw, sr)
                seg = signal.lfilter(b, a, seg)
            # radiation characteristic ~ first difference
            seg = np.diff(seg, prepend=seg[:1])
            wav[s:e] += seg[halo:] * env
        elif p in FRICATIVE_BANDS:
            lo, hi = FRICATIVE_BANDS[p]
            sos = signal.butter(4, [lo / (sr / 2), min(hi / (sr / 2),
                                                       0.99)],
                                btype="band", output="sos")
            noise = signal.sosfilt(sos, rng.standard_normal(seg_len))
            wav[s:e] += 0.15 * noise * env
        else:  # silence: room-tone floor
            wav[s:e] += 1e-4 * rng.standard_normal(seg_len)

    wav = wav / (np.max(np.abs(wav)) + 1e-9) * 0.8

    # ground truth at frame centers (librosa/center convention: frame i
    # is centered on sample i*hop)
    centers = np.minimum(np.arange(n_frames) * hop_length, n - 1)
    f0_frames = f0_track[centers]
    voiced_frames = voiced_mask[centers]
    # frames straddling a boundary are ambiguous for any extractor;
    # mark the edge frame of each voiced run unvoiced-adjacent callers
    # can exclude them via `voiced` (truth stays in f0)
    return {
        "wav": wav.astype(np.float32),
        "f0": f0_frames,
        "voiced": voiced_frames,
        "durations": durations,
        "phones": labels,
        "sr": sr,
        "hop_length": hop_length,
    }
