"""Minimal Praat TextGrid parsing + MFA duration extraction.

Replaces the reference's praatio+librosa pipeline (reference:
utils/gen_duration_from_textgrid.py:25-81) with a self-contained parser for
the standard (long) TextGrid text format, and the same frame-duration
conventions: interval ends -> frame positions (round(end * sr / hop)),
silence relabeling for MFA 1.x/2.x quirks.

The port's copy of ``parakeet_tpu/data/textgrid.py`` (pure Python).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["parse_textgrid", "textgrid_to_durations",
           "gen_duration_from_textgrid"]


def parse_textgrid(path) -> Dict[str, List[Tuple[float, float, str]]]:
    """Parse a TextGrid file into {tier_name: [(xmin, xmax, label), ...]}.

    Handles the standard long text format (the one MFA writes).
    """
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    # split into tier blocks
    tier_blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for block in tier_blocks:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if name_m is None:
            continue
        name = name_m.group(1)
        intervals = []
        for m in re.finditer(
                r'intervals\s*\[\d+\]\s*:\s*'
                r'xmin\s*=\s*([\d.eE+-]+)\s*'
                r'xmax\s*=\s*([\d.eE+-]+)\s*'
                r'text\s*=\s*"((?:[^"]|"")*)"', block):
            xmin, xmax = float(m.group(1)), float(m.group(2))
            label = m.group(3).replace('""', '"')
            intervals.append((xmin, xmax, label))
        tiers[name] = intervals
    return tiers


def _time_to_frame(times, sr: int, hop: int) -> np.ndarray:
    """Seconds -> frame index (floor of samples / hop, librosa convention)."""
    return np.floor(np.asarray(times, dtype=np.float64) * sr / hop).astype(
        np.int64)


def textgrid_to_durations(path, sample_rate: int = 24000, n_shift: int = 300,
                          tier: str = "phones") -> Tuple[List[str], List[int]]:
    """(phones, frame durations) from an MFA TextGrid.

    Applies the reference's MFA-version normalization
    (utils/gen_duration_from_textgrid.py:36-53): trailing ""+sp merge, final
    sp -> sil, edge "" -> sil, inner "" -> sp.
    """
    tiers = parse_textgrid(path)
    if tier not in tiers:
        raise KeyError(f"tier {tier!r} not in {list(tiers)} ({path})")
    phones = [label for _, _, label in tiers[tier]]
    ends = [xmax for _, xmax, _ in tiers[tier]]
    frame_pos = _time_to_frame(ends, sample_rate, n_shift)
    durations = np.diff(frame_pos, prepend=0).tolist()

    if len(phones) > 1 and phones[-1] == "" and phones[-2] == "sp":
        durations[-2] += durations[-1]
        phones, durations = phones[:-1], durations[:-1]
    if phones and phones[-1] == "sp":
        phones[-1] = "sil"
    phones = [
        ("sil" if i in (0, len(phones) - 1) else "sp") if p == "" else p
        for i, p in enumerate(phones)
    ]
    return phones, [int(d) for d in durations]


def gen_duration_from_textgrid(inputdir, output, sample_rate: int = 24000,
                               n_shift: int = 300) -> None:
    """Walk inputdir/<speaker>/*.TextGrid -> `utt|speaker|phn dur ...` file."""
    inputdir = Path(inputdir)
    rows = {}
    for spk_dir in sorted(p for p in inputdir.iterdir() if p.is_dir()):
        for tg in sorted(spk_dir.glob("*.TextGrid")):
            phones, durations = textgrid_to_durations(
                tg, sample_rate, n_shift)
            pd = " ".join(f"{p} {d}" for p, d in zip(phones, durations))
            rows[tg.stem] = (spk_dir.name, pd)
    with open(output, "w") as f:
        for utt in sorted(rows):
            spk, pd = rows[utt]
            f.write(f"{utt}|{spk}|{pd}\n")
