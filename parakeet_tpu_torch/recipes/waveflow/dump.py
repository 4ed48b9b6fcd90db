"""A seeded synthetic dump in the WaveFlow recipe's format, for smoke runs
and tests of the recipe without a corpus.

The WaveFlow recipe reads the PWGAN recipe's preprocess output
(``recipes/waveflow/preprocess.py`` is that stage): per split a
``metadata_<split>.jsonl`` whose rows hold the paths of a ``wave`` and a
``feats`` ``.npy``, so the dump is ``recipes/pwgan/dump.py``'s at the
WaveFlow YAML's hop of 256 samples.
"""
from __future__ import annotations

from typing import Dict, Sequence

from ..pwgan.dump import write_synthetic_dump as _pwgan_dump

__all__ = ["write_synthetic_dump"]


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], n_mels: int = 80,
                         n_shift: int = 256):
    """Write ``{split: utterances}`` of ``frames[0]``..``frames[1]`` mel
    frames (and ``n_shift`` samples a frame) each under ``out_dir``;
    returns {split: metadata path}.  The same seed writes the same
    arrays."""
    return _pwgan_dump(out_dir, seed=seed, splits=splits, frames=frames,
                       n_mels=n_mels, n_shift=n_shift)
