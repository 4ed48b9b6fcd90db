"""A seeded synthetic dump in the SpeedySpeech recipe's format, for smoke
runs and tests of the recipe without a corpus.

``recipes/speedyspeech/preprocess.py`` and ``normalize.py`` write, per
split, a ``metadata.jsonl`` whose rows hold the phone ids (``phones``),
the tone ids (``tones``), ``num_phones``, ``num_frames``, the phone
durations in frames and the path of the normalised mel (``feats``,
(frames, n_mels) ``.npy``); beside them ``phone_id_map.txt`` (<pad>,
<unk>, the phones, punctuation, <eos>) and ``tone_id_map.txt`` (tones
0-5, as ``build_phone_tone_id_maps`` writes them for Baker).  Here the
mels are standard normal and each utterance's durations are positive and
sum to its frames.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ...data import write_jsonl
from ..fastspeech2.dump import _SPECIALS, _TAIL, _write_map, split_durations

__all__ = ["write_synthetic_dump"]

TONES = [str(i) for i in range(6)]


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], phones: Sequence[int],
                         n_phones: int = 60, n_mels: int = 80
                         ) -> Dict[str, Path]:
    """Write ``{split: utterances}`` of ``frames[0]``..``frames[1]`` mel
    frames and ``phones[0]``..``phones[1]`` phones each under ``out_dir``.
    Returns {split: metadata path, "phones": the phone map, "tones": the
    tone map}.  The same seed writes the same dump."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {"phones": out_dir / "phone_id_map.txt",
             "tones": out_dir / "tone_id_map.txt"}
    _write_map(paths["phones"], _SPECIALS
               + [f"p{i:03d}" for i in range(n_phones)] + _TAIL)
    _write_map(paths["tones"], TONES)
    for split, count in splits.items():
        split_dir = out_dir / split
        split_dir.mkdir(exist_ok=True)
        rows = []
        for i in range(count):
            utt = f"{split}_{i:04d}"
            n_frames = int(rng.integers(frames[0], frames[1] + 1))
            n = int(rng.integers(phones[0], phones[1] + 1))
            feats = split_dir / f"{utt}_feats.npy"
            np.save(feats, rng.standard_normal((n_frames, n_mels)).astype(
                np.float32))
            rows.append({
                "utt_id": utt,
                "phones": rng.integers(len(_SPECIALS),
                                       len(_SPECIALS) + n_phones,
                                       n).tolist(),
                "tones": rng.integers(0, len(TONES), n).tolist(),
                "num_phones": n, "num_frames": n_frames,
                "durations": split_durations(rng, n_frames, n).tolist(),
                "feats": str(feats)})
        paths[split] = split_dir / "metadata.jsonl"
        write_jsonl(paths[split], rows)
    return paths
