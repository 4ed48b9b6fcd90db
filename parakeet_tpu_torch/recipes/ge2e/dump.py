"""A seeded synthetic mel tree in the GE2E recipe's layout, for smoke runs
and tests of the recipe without a corpus.

``preprocess.py`` writes one (frames, n_mels) log-mel ``.npy`` per
utterance under ``<root>/<speaker>/``.  Here each speaker's mels are
standard normal around a mean of its own (N(0, 1) per band), so that the
speakers differ.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["write_synthetic_mels"]


def write_synthetic_mels(root, *, seed: int, speakers: int,
                         utterances: int, frames: Sequence[int],
                         n_mels: int = 40) -> Path:
    """Write ``speakers`` x ``utterances`` mels of ``frames[0]``..
    ``frames[1]`` frames under ``root``; returns the resolved root.  The
    same seed writes the same tree."""
    root = Path(root).resolve()
    rng = np.random.default_rng(seed)
    for s in range(speakers):
        spk_dir = root / f"spk{s:04d}"
        spk_dir.mkdir(parents=True, exist_ok=True)
        mean = rng.standard_normal(n_mels)
        for u in range(utterances):
            n = int(rng.integers(frames[0], frames[1] + 1))
            mel = mean + rng.standard_normal((n, n_mels))
            np.save(spk_dir / f"utt{u:04d}.npy", mel.astype(np.float32))
    return root
