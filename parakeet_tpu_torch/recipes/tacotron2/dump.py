"""A seeded synthetic dump in the Tacotron2 recipe's format, for smoke runs
and tests of the recipe without a corpus.

``recipes/tacotron2/preprocess.py`` (the TransformerTTS pipeline with a
character frontend) and the normalize stage write, per split, a
``metadata.jsonl`` whose rows hold the token ids (``text``) and the path
of the normalised mel (``speech``, (frames, n_mels) ``.npy``), and a
``phone_id_map.txt``.  Here the mels are standard normal.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ...data import write_jsonl
from ..fastspeech2.dump import _SPECIALS, _TAIL, _write_map

__all__ = ["write_synthetic_dump"]


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], phones: Sequence[int],
                         n_phones: int = 60, n_mels: int = 80
                         ) -> Dict[str, Path]:
    """Write ``{split: utterances}`` of ``frames[0]``..``frames[1]`` mel
    frames and ``phones[0]``..``phones[1]`` tokens each under ``out_dir``.
    Returns {split: metadata path, "phones": the token map}.  The same
    seed writes the same dump."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {"phones": out_dir / "phone_id_map.txt"}
    _write_map(paths["phones"], _SPECIALS
               + [f"p{i:03d}" for i in range(n_phones)] + _TAIL)
    for split, count in splits.items():
        split_dir = out_dir / split
        split_dir.mkdir(exist_ok=True)
        rows = []
        for i in range(count):
            utt = f"{split}_{i:04d}"
            n_frames = int(rng.integers(frames[0], frames[1] + 1))
            n = int(rng.integers(phones[0], phones[1] + 1))
            speech = split_dir / f"{utt}_speech.npy"
            np.save(speech, rng.standard_normal((n_frames, n_mels)).astype(
                np.float32))
            rows.append({"utt_id": utt,
                         "text": rng.integers(len(_SPECIALS),
                                              len(_SPECIALS) + n_phones,
                                              n).tolist(),
                         "speech": str(speech)})
        paths[split] = split_dir / "metadata.jsonl"
        write_jsonl(paths[split], rows)
    return paths
