"""Host-side audio/DSP of the port (a copy of ``parakeet_tpu.audio``, numpy
and scipy only): STFT, mel, pitch, energy, normalizers, IO."""
from .codec import (dequantize, load_wav, mu_law_decode, mu_law_encode,
                    quantize, save_wav)
from .features import Energy, LogMelFBank, Pitch, average_by_duration
from .normalizer import LogMagnitude, NormalizerBase, UnitMagnitude
from .spectrum import (frame_signal, get_window, hz_to_mel, istft,
                       mel_filterbank, mel_to_hz, spectrogram, stft)

__all__ = [
    "LogMelFBank", "Pitch", "Energy", "average_by_duration",
    "LogMagnitude", "UnitMagnitude", "NormalizerBase",
    "stft", "istft", "spectrogram", "mel_filterbank", "hz_to_mel",
    "mel_to_hz", "get_window", "frame_signal",
    "load_wav", "save_wav", "quantize", "dequantize", "mu_law_encode",
    "mu_law_decode",
]
