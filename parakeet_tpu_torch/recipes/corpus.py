"""Seeded formant corpora in the layouts the recipes' ``run.sh`` pipelines
read, for driving them end to end where no recorded corpus is at hand
(none ships with this repository).

Every utterance is ``audio/synthetic.py::formant_utterance`` speech built
from pinyin syllables: an initial of ``INITIALS`` (fricative noise) and a
toned final of ``FINALS`` (voiced, with formants), between silences,
some with a short pause ("sp").  The syllables cycle through every
(initial, final, tone) so that any corpus of ``len(SYLLABLES)`` syllables
or more holds every phone the sentences of ``SENTENCES`` and
``PINYIN_SENTENCES`` reach through the Chinese frontend.

- ``write_baker_corpus``: ``wavs/<utt>.wav`` and ``durations.txt`` (MFA's
  ``utt|spk|phone dur ...``), the input of the FastSpeech2, SpeedySpeech,
  Tacotron2, TransformerTTS, PWGAN and WaveFlow pipelines;
- ``write_speaker_tree``: ``<spk>/<utt>.wav`` for GE2E, and with
  ``label`` the AISHELL-3 transcript (``utt|chars|pinyin``) of the voice
  cloning pipeline;
- ``write_sentences``: a ``--text`` file of ``<utt_id> <sentence>`` lines.
"""
import itertools
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..audio.codec import save_wav
from ..audio.synthetic import formant_utterance

__all__ = ["INITIALS", "FINALS", "SYLLABLES", "SENTENCES",
           "PINYIN_SENTENCES", "write_baker_corpus", "write_speaker_tree",
           "write_sentences"]

INITIALS = ("sh", "s", "f", "h")
FINALS = ("a", "u", "e")
# every pinyin syllable of them but "fe", which Mandarin lacks
SYLLABLES = [s for s in itertools.product(INITIALS, FINALS, (1, 2, 3, 4))
             if s[:2] != ("f", "e")]
# text -> phones of the inventory alone (as the frontend reads them with
# jieba and without it: every word one character)
SENTENCES = [("s001", "沙发书法湖。"), ("s002", "苏河喝福。"),
             ("s003", "哈萨虎父。")]
PINYIN_SENTENCES = [("p001", "sha1 fa1 shu1 fa3 hu2"),
                    ("p002", "su1 he2 he1 fu2")]


def _utterance_phones(rng: np.random.Generator, syllables: Sequence[Tuple],
                     pause: bool) -> List[Tuple[str, str, float]]:
    """(label, synthesised phone, seconds) of one utterance: silence, the
    syllables (a short pause after the first when ``pause``), silence."""
    out = [("sil", "sil", 0.08)]
    for k, (initial, final, tone) in enumerate(syllables):
        out.append((initial, initial, float(rng.uniform(0.05, 0.08))))
        out.append((f"{final}{tone}", final, float(rng.uniform(0.1, 0.16))))
        if pause and k == 0:
            out.append(("sp", "sp", 0.05))
    out.append(("sil", "sil", 0.08))
    return out


def _utterances(n: int, syllables: Tuple[int, int], seed: int):
    """``n`` utterances of ``syllables[0]``-``syllables[1]`` syllables
    each, cycling through SYLLABLES; yields (index, phones)."""
    rng = np.random.default_rng(seed)
    cycle = itertools.cycle(SYLLABLES)
    for i in range(n):
        k = int(rng.integers(syllables[0], syllables[1] + 1))
        yield i, _utterance_phones(rng, [next(cycle) for _ in range(k)],
                                  pause=i % 5 == 0)


def _synthesise(phones, sr: int, hop: int, seed: int, f0: float):
    return formant_utterance([(p, d) for _, p, d in phones], sr=sr,
                             hop_length=hop, f0_start=f0,
                             f0_end=0.65 * f0, seed=seed)


def write_baker_corpus(out, n: int, seed: int = 0,
                       syllables: Tuple[int, int] = (2, 3), sr: int = 24000,
                       hop: int = 300, speakers: int = 2) -> Path:
    """``n`` utterances ``utt0000``... under ``out/wavs`` at ``sr`` and
    their durations in frames of ``hop`` samples in
    ``out/durations.txt`` (speakers ``spk0``...); returns ``out``."""
    out = Path(out)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    lines = []
    for i, phones in _utterances(n, syllables, seed):
        utt = f"utt{i:04d}"
        spk = i % speakers
        wav = _synthesise(phones, sr, hop, seed + i, 110.0 + 50.0 * spk)
        save_wav(out / "wavs" / f"{utt}.wav", wav["wav"], sr)
        lines.append(f"{utt}|spk{spk}|" + " ".join(
            f"{label} {d}" for (label, _, _), d in zip(phones,
                                                       wav["durations"])))
    (out / "durations.txt").write_text("\n".join(lines) + "\n")
    return out


def write_speaker_tree(out, speakers: Sequence[str], per_speaker: int,
                       seed: int = 0, syllables: Tuple[int, int] = (2, 3),
                       sr: int = 16000, label=None) -> List[str]:
    """``per_speaker`` utterances ``<spk><i:04d>.wav`` under each
    ``out/<spk>`` at ``sr``; with ``label``, their transcript in
    AISHELL-3's ``utt|chars|pinyin`` form there (the characters are
    placeholders: the pipeline reads the pinyin).  Returns the utterance
    ids."""
    out = Path(out)
    utts, rows = [], []
    for i, phones in _utterances(len(speakers) * per_speaker, syllables,
                                 seed):
        s, spk = i // per_speaker, speakers[i // per_speaker]
        utt = f"{spk}{i % per_speaker:04d}"
        (out / spk).mkdir(parents=True, exist_ok=True)
        wav = _synthesise(phones, sr, sr // 100, seed + i, 100.0 + 40.0 * s)
        save_wav(out / spk / f"{utt}.wav", wav["wav"], sr)
        initials = [p for p, _, _ in phones if p in INITIALS]
        finals = [p for p, _, _ in phones if p[-1].isdigit()]
        rows.append(f"{utt}|{'字' * len(finals)}|" + " ".join(
            a + b for a, b in zip(initials, finals)))
        utts.append(utt)
    if label is not None:
        Path(label).parent.mkdir(parents=True, exist_ok=True)
        Path(label).write_text("\n".join(rows) + "\n", encoding="utf-8")
    return utts


def write_sentences(path, sentences: Sequence[Tuple[str, str]]) -> Path:
    """``<utt_id> <sentence>`` lines; returns ``path``."""
    path = Path(path)
    path.write_text("".join(f"{u} {s}\n" for u, s in sentences),
                    encoding="utf-8")
    return path
