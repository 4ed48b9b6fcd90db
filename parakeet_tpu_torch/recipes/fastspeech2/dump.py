"""A seeded synthetic dump in the FastSpeech2 recipe's format, for smoke
runs and tests of the recipe without a corpus.

``recipes/fastspeech2/preprocess.py`` and ``normalize.py`` write, per
split, a ``metadata.jsonl`` whose rows hold the phone ids (``text``), the
phone durations in frames, and the paths of ``.npy`` arrays: ``speech``
(frames, n_mels), ``pitch`` and ``energy`` (phones, 1), normalised; with
speakers also ``spk_id``.  Beside them a ``phones.txt`` (``phone id``
lines: <pad>, <unk>, the phones, four punctuation marks and <eos>, as
``build_phone_id_map`` writes) and a ``speaker_id_map.txt``.  Here the
arrays are standard normal, and each utterance's durations are positive
and sum to its frames.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ...data import write_jsonl

__all__ = ["write_synthetic_dump", "split_durations"]

_SPECIALS = ["<pad>", "<unk>"]
_TAIL = [",", ".", "?", "!", "<eos>"]


def _write_map(path: Path, names) -> None:
    path.write_text("".join(f"{n} {i}\n" for i, n in enumerate(names)))


def split_durations(rng: np.random.Generator, n_frames: int,
                    n: int) -> np.ndarray:
    """``n`` positive durations that sum to ``n_frames``: ``n - 1``
    distinct cuts of the frames, drawn from ``rng``."""
    cuts = np.sort(rng.choice(np.arange(1, n_frames), n - 1, replace=False))
    return np.diff(np.concatenate([[0], cuts, [n_frames]]))


def write_synthetic_dump(out_dir, *, seed: int, splits: Dict[str, int],
                         frames: Sequence[int], phones: Sequence[int],
                         n_phones: int = 60, n_mels: int = 80,
                         speakers: Optional[int] = None) -> Dict[str, Path]:
    """Write ``{split: utterances}`` of ``frames[0]``..``frames[1]`` mel
    frames and ``phones[0]``..``phones[1]`` phones each (drawn from a
    vocabulary of ``n_phones``) under ``out_dir``, with ``speakers``
    speakers if given.  Returns {split: metadata path, "phones": the phone
    map, "speakers": the speaker map (with ``speakers``)}.  The same seed
    writes the same dump."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {"phones": out_dir / "phones.txt"}
    _write_map(paths["phones"], _SPECIALS
               + [f"p{i:03d}" for i in range(n_phones)] + _TAIL)
    if speakers is not None:
        paths["speakers"] = out_dir / "speaker_id_map.txt"
        _write_map(paths["speakers"], [f"spk{i:03d}" for i in
                                       range(speakers)])
    for split, count in splits.items():
        split_dir = out_dir / split
        split_dir.mkdir(exist_ok=True)
        rows = []
        for i in range(count):
            utt = f"{split}_{i:04d}"
            n_frames = int(rng.integers(frames[0], frames[1] + 1))
            n = int(rng.integers(phones[0], phones[1] + 1))
            durations = split_durations(rng, n_frames, n)
            row = {"utt_id": utt,
                   "text": rng.integers(len(_SPECIALS),
                                        len(_SPECIALS) + n_phones,
                                        n).tolist(),
                   "text_lengths": n, "speech_lengths": n_frames,
                   "durations": durations.tolist()}
            for key, shape in (("speech", (n_frames, n_mels)),
                               ("pitch", (n, 1)), ("energy", (n, 1))):
                path = split_dir / f"{utt}_{key}.npy"
                np.save(path, rng.standard_normal(shape).astype(np.float32))
                row[key] = str(path)
            if speakers is not None:
                row["spk_id"] = int(rng.integers(speakers))
            rows.append(row)
        paths[split] = split_dir / "metadata.jsonl"
        write_jsonl(paths[split], rows)
    return paths
