"""Corpus preprocessing helpers shared by the recipes.

Equivalents of the reference's preprocess utilities (reference:
parakeet/datasets/preprocess_utils.py:19-187): duration-file parsing,
silence merging, vocab construction, duration/mel length reconciliation,
plus running statistics for Z-score normalization (replacing sklearn's
StandardScaler partial_fit in examples/*/compute_statistics.py).

The port's copy of ``parakeet_tpu/data/preprocess.py`` (pure Python).
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Set, Tuple

import numpy as np

__all__ = [
    "read_duration_file", "merge_silence", "build_phone_id_map",
    "build_phone_tone_id_maps", "build_spk_id_map", "load_id_map",
    "reconcile_durations", "cut_silence", "RunningStats",
]

Sentence = Dict[str, list]  # utt -> [phones, durations, speaker]


def read_duration_file(path) -> Tuple[Sentence, Set[str]]:
    """Parse `utt|speaker|phn dur phn dur ...` lines.

    Returns ({utt: [phones, durations, speaker]}, speaker set).
    """
    sentences: Sentence = {}
    speakers: Set[str] = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, speaker, pd = line.split("|")
            tokens = pd.split()
            phones, durs = tokens[::2], [int(d) for d in tokens[1::2]]
            if len(phones) != len(durs):
                raise ValueError(f"odd phone/dur tokens for {utt}")
            sentences[utt] = [phones, durs, speaker]
            speakers.add(speaker)
    return sentences, speakers


def merge_silence(sentences: Sentence, long_sp_threshold: int = 14) -> None:
    """In-place: collapse consecutive sil/sp runs into one sil; relabel
    long short-pauses as 'spl' (same policy as the reference,
    parakeet/datasets/preprocess_utils.py:49-79)."""
    for utt, (phones, durs, speaker) in sentences.items():
        new_p: List[str] = []
        new_d: List[int] = []
        for p, d in zip(phones, durs):
            if new_p and p == "sil" and new_p[-1] in ("sil", "sp"):
                new_p[-1] = "sil"
                new_d[-1] += d
            else:
                new_p.append(p)
                new_d.append(d)
        new_p = [
            ("spl" if p == "sp" and d >= long_sp_threshold else p)
            for p, d in zip(new_p, new_d)
        ]
        sentences[utt] = [new_p, new_d, speaker]


def cut_silence(wav: np.ndarray, phones: List[str], durations: List[int],
                n_shift: int, sil_phone: str = "sil"):
    """Trim a leading/trailing silence phone from the utterance.

    Mirrors the reference recipe's cut_sil branch (reference:
    examples/GANVocoder/preprocess.py:61-75): drop the first/last phone
    when it is ``sil`` (keeping at least one phone), slice the waveform
    to the remaining duration span (frames * n_shift samples).

    Returns ``(wav, phones, durations)`` — new lists, input untouched.
    """
    phones = list(phones)
    durations = [int(d) for d in durations]
    start_f = 0
    end_f = int(np.sum(durations))
    if phones and phones[0] == sil_phone and len(durations) > 1:
        start_f = durations[0]
        phones, durations = phones[1:], durations[1:]
    if phones and phones[-1] == sil_phone and len(durations) > 1:
        end_f -= durations[-1]
        phones, durations = phones[:-1], durations[:-1]
    return wav[start_f * n_shift:end_f * n_shift], phones, durations


_ZH_PUNCS = ["，", "。", "？", "！"]  # ，。？！
_EN_PUNCS = [",", ".", "?", "!"]


def build_phone_id_map(sentences: Sentence, output_path,
                       dataset: str = "baker") -> List[str]:
    """Collect the phone set, add specials + punctuation, write `phn id`."""
    phones = sorted({p for utt in sentences for p in sentences[utt][0]})
    puncs = _ZH_PUNCS if dataset in ("baker", "aishell3") else _EN_PUNCS
    table = ["<pad>", "<unk>"] + phones + puncs + ["<eos>"]
    with open(output_path, "w") as f:
        for i, p in enumerate(table):
            f.write(f"{p} {i}\n")
    return table


def build_phone_tone_id_maps(sentences: Sentence, phones_path, tones_path,
                             dataset: str = "baker"
                             ) -> Tuple[List[str], List[str]]:
    """Split tones off finals (e.g. 'ang4' -> 'ang', '4'), write both maps."""
    phones: Set[str] = set()
    tones: Set[str] = set()
    for utt in sentences:
        for label in sentences[utt][0]:
            m = re.match(r"^(\w+)([012345])$", label)
            if m:
                phones.add(m.group(1))
                tones.add(m.group(2))
            else:
                phones.add(label)
                tones.add("0")
    puncs = _ZH_PUNCS if dataset in ("baker", "aishell3") else _EN_PUNCS
    phone_table = ["<pad>", "<unk>"] + sorted(phones) + puncs + ["<eos>"]
    tone_table = sorted(tones)
    with open(phones_path, "w") as f:
        for i, p in enumerate(phone_table):
            f.write(f"{p} {i}\n")
    with open(tones_path, "w") as f:
        for i, t in enumerate(tone_table):
            f.write(f"{t} {i}\n")
    return phone_table, tone_table


def build_spk_id_map(speakers: Iterable[str], output_path) -> List[str]:
    speakers = sorted(speakers)
    with open(output_path, "w") as f:
        for i, s in enumerate(speakers):
            f.write(f"{s} {i}\n")
    return speakers


def load_id_map(path) -> Dict[str, int]:
    """Read `token id` lines into a dict."""
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) == 2:
                table[parts[0]] = int(parts[1])
    return table


def reconcile_durations(sentences: Sentence, utt: str,
                        n_frames: int) -> bool:
    """Adjust durations so sum(durations) == n_frames; drop if impossible.

    Same correction policy as the reference
    (parakeet/datasets/preprocess_utils.py:163-187): absorb the difference
    into the last (or first) token.  Returns True if the utt survives.
    """
    if utt not in sentences:
        return False
    durs = sentences[utt][1]
    diff = n_frames - sum(durs)
    if diff == 0:
        return True
    if diff > 0 or durs[-1] + diff > 0:
        durs[-1] += diff
    elif durs[0] + diff > 0:
        durs[0] += diff
    else:
        sentences.pop(utt)
        return False
    return True


class RunningStats:
    """Streaming per-dimension mean/std (Welford).

    Replaces sklearn StandardScaler.partial_fit in the reference's
    compute_statistics step (examples/*/compute_statistics.py); produces
    the same `stats.npy` = [mean, scale] layout consumed by ZScore.
    """

    def __init__(self, dim: int):
        self.n = 0
        self.mean = np.zeros(dim, dtype=np.float64)
        self.m2 = np.zeros(dim, dtype=np.float64)

    def update(self, x: np.ndarray) -> None:
        """x: (n_frames, dim) batch of observations (Chan's batched merge)."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        m = x.shape[0]
        if m == 0:
            return
        batch_mean = x.mean(axis=0)
        batch_m2 = np.square(x - batch_mean).sum(axis=0)
        delta = batch_mean - self.mean
        total = self.n + m
        self.mean += delta * (m / total)
        self.m2 += batch_m2 + np.square(delta) * (self.n * m / total)
        self.n = total

    @property
    def std(self) -> np.ndarray:
        if self.n < 2:
            return np.ones_like(self.mean)
        return np.sqrt(self.m2 / self.n)

    def save(self, path) -> None:
        np.save(path, np.stack([
            self.mean.astype(np.float32),
            self.std.astype(np.float32)
        ]))

    @staticmethod
    def load(path) -> Tuple[np.ndarray, np.ndarray]:
        arr = np.load(path)
        return arr[0], arr[1]
