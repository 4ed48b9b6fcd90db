"""A seeded synthetic dump in the voice-cloning recipe's format, for smoke
runs and tests of the recipe without a corpus.

``chinese_g2p.py`` writes ``metadata.jsonl`` rows holding the phone ids
(``text``), the path of the mel (``speech``, (frames, n_mels) ``.npy``)
and that of the utterance's GE2E embedding (``spk_emb``, (256,) ``.npy``),
and a ``phone_id_map.txt``.  Here the Tacotron2 recipe's dump
(``recipes/tacotron2/dump.py``, standard normal mels) gains, per row, a
unit-length embedding near its speaker's (``speakers`` of them, drawn
from the same seed).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ...data import DataTable, write_jsonl
from ..tacotron2.dump import write_synthetic_dump as write_tacotron2_dump

__all__ = ["write_synthetic_dump"]


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], phones: Sequence[int],
                         speakers: int = 4, d_spk_emb: int = 256,
                         n_mels: int = 80):
    """The Tacotron2 recipe's dump under ``out_dir`` with an ``spk_emb``
    a row; returns {split: metadata path, "phones": the token map}.  The
    same seed writes the same dump."""
    paths = write_tacotron2_dump(out_dir, seed=seed, splits=splits,
                                 frames=frames, phones=phones,
                                 n_mels=n_mels)
    rng = np.random.default_rng(seed + 1)
    centres = rng.standard_normal((speakers, d_spk_emb))
    for split in splits:
        rows = list(DataTable.from_jsonl(paths[split]).data)
        for row in rows:
            spk = int(rng.integers(speakers))
            emb = centres[spk] + 0.3 * rng.standard_normal(d_spk_emb)
            path = paths[split].parent / f"{row['utt_id']}_spk_emb.npy"
            np.save(path, (emb / np.linalg.norm(emb)).astype(np.float32))
            row.update(spk=f"spk{spk}", spk_emb=str(path))
        write_jsonl(paths[split], rows)
    return paths
