"""A seeded synthetic dump in the PWGAN recipe's format, for smoke runs and
tests of the recipe without a corpus.

``recipes/pwgan/preprocess.py`` writes, per utterance, ``{utt}_wave.npy``
(float32, num_frames * n_shift samples) and ``{utt}_feats.npy`` (float32
log-mel, (num_frames, n_mels)), and one ``metadata_<split>.jsonl`` row
each: utt_id, num_samples, num_frames and the two paths.  Here the arrays
are random: a wave of amplitude ~0.3 and a normalised mel.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ...data import write_jsonl

__all__ = ["write_synthetic_dump"]


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], n_mels: int = 80,
                         n_shift: int = 300) -> Dict[str, Path]:
    """Write ``{split: utterances}`` of ``frames[0]``..``frames[1]`` mel
    frames each under ``out_dir``; returns {split: metadata path}.  The
    same seed writes the same arrays."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {}
    for split, count in splits.items():
        rows = []
        for i in range(count):
            utt = f"{split}_{i:04d}"
            n = int(rng.integers(frames[0], frames[1] + 1))
            wave = (0.3 * rng.standard_normal(n * n_shift)).astype(np.float32)
            feats = rng.standard_normal((n, n_mels)).astype(np.float32)
            wave_path = out_dir / f"{utt}_wave.npy"
            feats_path = out_dir / f"{utt}_feats.npy"
            np.save(wave_path, wave)
            np.save(feats_path, feats)
            rows.append({"utt_id": utt, "num_samples": int(wave.size),
                         "num_frames": n, "wave": str(wave_path),
                         "feats": str(feats_path)})
        paths[split] = out_dir / f"metadata_{split}.jsonl"
        write_jsonl(paths[split], rows)
    return paths
