"""Audio corpus datasets.

Equivalents of the reference's audio datasets and LJSpeech metadata reader
(reference: parakeet/datasets/common.py:24-92, parakeet/datasets/
ljspeech.py:21-39), built on scipy wav IO instead of librosa.

The port's copy of ``parakeet_tpu/data/datasets.py`` (numpy and scipy).
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..audio.codec import load_wav

__all__ = ["AudioSegmentDataset", "AudioDataset", "AudioFolderDataset",
           "LJSpeechMetaData"]


class AudioDataset:
    """Wav files -> float waveforms, with optional trimming/normalization."""

    def __init__(self, file_paths: List, sample_rate: Optional[int] = None,
                 volume_normalize: bool = False,
                 trim_db: Optional[float] = None):
        self.file_paths = list(file_paths)
        self.sample_rate = sample_rate
        self.volume_normalize = volume_normalize
        self.trim_db = trim_db

    def _trim(self, wav: np.ndarray) -> np.ndarray:
        """Strip leading/trailing samples quieter than trim_db below peak."""
        if self.trim_db is None or len(wav) == 0:
            return wav
        frame, hop = 2048, 512
        n = max(1, 1 + (len(wav) - frame) // hop)
        rms = np.array([
            np.sqrt(np.mean(wav[i * hop:i * hop + frame] ** 2) + 1e-12)
            for i in range(n)
        ])
        db = 20 * np.log10(rms / (np.max(np.abs(wav)) + 1e-12) + 1e-12)
        keep = np.flatnonzero(db > -self.trim_db)
        if keep.size == 0:
            return wav
        start = keep[0] * hop
        end = min(len(wav), keep[-1] * hop + frame)
        return wav[start:end]

    def __len__(self):
        return len(self.file_paths)

    def __getitem__(self, i):
        wav, _ = load_wav(self.file_paths[i], sr=self.sample_rate)
        wav = self._trim(wav)
        if self.volume_normalize:
            peak = np.max(np.abs(wav))
            if peak > 0:
                wav = wav / peak * 0.999
        return wav


class AudioSegmentDataset(AudioDataset):
    """AudioDataset yielding random fixed-length clips (pad short files)."""

    def __init__(self, file_paths, segment_length: int, seed: int = 0,
                 **kwargs):
        super().__init__(file_paths, **kwargs)
        self.segment_length = segment_length
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, i):
        wav = super().__getitem__(i)
        n = self.segment_length
        if len(wav) >= n:
            start = int(self.rng.integers(0, len(wav) - n + 1))
            return wav[start:start + n]
        return np.pad(wav, (0, n - len(wav)))


class AudioFolderDataset(AudioDataset):
    """All `*.<ext>` files under a directory, sorted."""

    def __init__(self, root, extension: str = "wav", **kwargs):
        paths = sorted(Path(root).rglob(f"*.{extension}"))
        super().__init__(paths, **kwargs)


class LJSpeechMetaData:
    """LJSpeech-1.1 metadata.csv -> (wav path, normalized text, raw text)."""

    def __init__(self, root):
        root = Path(root)
        self.records = []
        with open(root / "metadata.csv", encoding="utf-8") as f:
            for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
                utt_id, raw, normalized = row[0], row[1], row[-1]
                self.records.append(
                    (str(root / "wavs" / f"{utt_id}.wav"), normalized, raw))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]
