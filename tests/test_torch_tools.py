"""The port's tool twins (``parakeet_tpu_torch/tools/``) against the
repository's JAX-side tools (``tools/``), on the CPU: each twin run as
``python -m parakeet_tpu_torch.tools.<name>`` in a process of its own, the
JAX tool as ``__main__`` in this one (``sys.argv`` patched), on the same
seeded inputs; their output files are compared byte for byte (the
resampled wavs in samples, within one step of the 16-bit codec).

- ``gen_duration_from_textgrid``: a TextGrid tree of two speakers (the
  MFA cases of tests/test_torch_text_data.py) at two ``--fs``/
  ``--n-shift`` pairs;
- ``mfa.generate_lexicon``: under each ``--with-tone``/``--with-r``;
- ``mfa.reorganize_baker``: a Baker layout (``ProsodyLabeling`` and 48 kHz
  wavs), copied and resampled to 16 kHz, with and without tones;
- ``mfa.reorganize_vctk``: a VCTK layout (mic1 and mic2 takes, a speaker
  without text and a log file that are skipped);
- ``make_cmudict_eval``: a small CMUdict made from the built-in lexicon,
  derived spellings, other words, variants and entries the loader drops,
  at two seeds.
"""
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from parakeet_tpu_torch.audio.codec import save_wav
from parakeet_tpu_torch.audio.synthetic import formant_utterance
from parakeet_tpu_torch.frontend._arpabet_data import BUILTIN_LEXICON
from test_torch_text_data import _random_intervals, _textgrid

ROOT = Path(__file__).resolve().parents[1]


def _run_both(monkeypatch, jax_tool, port_module, jax_args, port_args):
    """The JAX tool in this process, then the twin as ``python -m``."""
    monkeypatch.setattr(sys, "argv", [jax_tool, *map(str, jax_args)])
    runpy.run_path(str(ROOT / "tools" / jax_tool), run_name="__main__")
    proc = subprocess.run(
        [sys.executable, "-m", f"parakeet_tpu_torch.tools.{port_module}",
         *map(str, port_args)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _same_files(a, b, wav_tol=0):
    """The same relative files under ``a`` and ``b``, byte for byte; wavs
    in 16-bit samples within ``wav_tol`` steps."""
    from scipy.io import wavfile
    files = sorted(p.relative_to(a) for p in Path(a).rglob("*")
                   if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in
                                     Path(b).rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".wav":
            (ra, x), (rb, y) = wavfile.read(a / rel), wavfile.read(b / rel)
            assert ra == rb and x.dtype == y.dtype and x.shape == y.shape
            assert np.abs(x.astype(np.int32) - y).max() <= wav_tol, rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return files


@pytest.mark.parametrize("fs,n_shift", [(24000, 300), (22050, 256)])
def test_gen_duration_from_textgrid_writes_the_jax_bytes(tmp_path,
                                                         monkeypatch, fs,
                                                         n_shift):
    rng = np.random.default_rng(4)
    cases = [["", "n", "i3", "", "h", "ao3", "sp", ""],
             ["sil", "AH0", "B", "sp"], ["", 'q""t', "er2", ""],
             ["zh", "ong1"], ["sil", "sh", "a1", "sil"]]
    root = tmp_path / "mfa"
    for i, labels in enumerate(cases):
        d = root / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"utt{i}.TextGrid").write_text(
            _textgrid(_random_intervals(rng, labels)), encoding="utf-8")
    flags = ["--inputdir", root, "--fs", fs, "--n-shift", n_shift]
    out = _run_both(monkeypatch, "gen_duration_from_textgrid.py",
                    "gen_duration_from_textgrid",
                    flags + ["--output", tmp_path / "jax.txt"],
                    flags + ["--output", tmp_path / "port.txt"])
    assert f"wrote {len(cases)} utterances" in out
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    assert len(port.splitlines()) == len(cases)


@pytest.mark.parametrize("flags", [[], ["--with-tone"], ["--with-r"],
                                   ["--with-tone", "--with-r"]])
def test_generate_lexicon_writes_the_jax_bytes(tmp_path, monkeypatch, flags):
    _run_both(monkeypatch, "mfa/generate_lexicon.py", "mfa.generate_lexicon",
              [tmp_path / "jax" / "simple", *flags],
              [tmp_path / "port" / "simple", *flags])
    _same_files(tmp_path / "jax", tmp_path / "port")
    rows = (tmp_path / "port" / "simple.lexicon").read_text().splitlines()
    assert ("sha1 sh a1" in rows) == ("--with-tone" in flags)
    assert any(r.startswith("huar") for r in rows) == ("--with-r" in flags)


def _utterance_wav(path, sr, seed):
    utt = formant_utterance([("sil", 0.05), ("a", 0.15), ("s", 0.08),
                             ("i", 0.12), ("sil", 0.05)], sr=sr,
                            hop_length=sr // 100, seed=seed)
    save_wav(path, utt["wav"], sr)


@pytest.mark.parametrize("flags", [["--resample-audio"], ["--with-tone"]])
def test_reorganize_baker_writes_the_jax_files(tmp_path, monkeypatch, flags):
    """Three 48 kHz wavs and their ProsodyLabeling pairs (prosody marks,
    tone digits, a neutral-tone syllable without one)."""
    root = tmp_path / "BZNSYP"
    (root / "Wave").mkdir(parents=True)
    (root / "ProsodyLabeling").mkdir()
    lines = []
    for i, pinyin in enumerate(["ka2 er2 pu3 pei2", "wan2 hua2 ti1 de",
                                "bao2 ma3 er2"], 1):
        _utterance_wav(root / "Wave" / f"{i:06d}.wav", 48000, i)
        lines += [f"{i:06d}\t卡尔#2普陪#1外孙#4。", f"\t{pinyin}"]
    (root / "ProsodyLabeling" / "000001-010000.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    _run_both(monkeypatch, "mfa/reorganize_baker.py", "mfa.reorganize_baker",
              ["--root-dir", root, "--output-dir", tmp_path / "jax", *flags],
              ["--root-dir", root, "--output-dir", tmp_path / "port",
               *flags])
    files = _same_files(tmp_path / "jax", tmp_path / "port", wav_tol=1)
    assert len(files) == 6
    lab = (tmp_path / "port" / "000002.lab").read_text()
    assert lab == ("wan2 hua2 ti1 de\n" if "--with-tone" in flags
                   else "wan hua ti de\n")
    from scipy.io import wavfile
    rate = wavfile.read(tmp_path / "port" / "000001.wav")[0]
    assert rate == (16000 if "--resample-audio" in flags else 48000)


def test_reorganize_vctk_writes_the_jax_files(tmp_path, monkeypatch):
    """Two speakers' mic1 and mic2 takes at 48 kHz (mic2 kept, resampled to
    16 kHz), their transcripts, p315 (no text) and log.txt skipped."""
    root = tmp_path / "VCTK-Corpus-0.92"
    wav_dir, txt_dir = root / "wav48_silence_trimmed", root / "txt"
    for s, spk in enumerate(["p225", "p226", "p315"]):
        (wav_dir / spk).mkdir(parents=True)
        (txt_dir / spk).mkdir(parents=True)
        for k in (1, 2):
            for mic in ("mic1", "mic2"):
                _utterance_wav(wav_dir / spk / f"{spk}_{k:03d}_{mic}.wav",
                               48000, 10 * s + k)
            (txt_dir / spk / f"{spk}_{k:03d}.txt").write_text(
                f"  Please call Stella {k}.  \n", encoding="utf-8")
    (wav_dir / "log.txt").write_text("log\n")
    _run_both(monkeypatch, "mfa/reorganize_vctk.py", "mfa.reorganize_vctk",
              ["--root-dir", root, "--output-dir", tmp_path / "jax"],
              ["--root-dir", root, "--output-dir", tmp_path / "port"])
    files = _same_files(tmp_path / "jax", tmp_path / "port", wav_tol=1)
    assert [str(f) for f in files] == [
        f"{spk}/{spk}_{k:03d}.{ext}" for spk in ("p225", "p226")
        for k in (1, 2) for ext in ("lab", "wav")]


def _cmudict(path, seed):
    """A CMUdict-format file: built-in words, derived spellings of them,
    other words, alternate pronunciations, and entries the loader drops
    (comments, punctuation, digits)."""
    rng = np.random.default_rng(seed)
    phones = ["AH0", "B", "K", "AE1", "T", "S", "IY1", "N", "D", "ER0"]
    words = sorted(BUILTIN_LEXICON)
    base = [words[i] for i in rng.choice(len(words), 60, replace=False)]
    entries = base + [w + s for w in base[:30] for s in ("s", "ed", "ing")]
    entries += [f"zq{chr(97 + i)}{chr(97 + j)}" for i in range(6)
                for j in range(5)]
    lines = [";;; # CMUdict  --  Major Version: 0.07", ";;; comment"]
    for w in entries:
        pron = " ".join(rng.choice(phones, int(rng.integers(2, 6))))
        lines.append(f"{w.upper()}  {pron}")
        if rng.random() < 0.2:
            lines.append(f"{w.upper()}(1)  {pron} S")
    lines += ["!EXCLAMATION-POINT  EH2 K S K L AH0 M EY1 SH AH0 N",
              "'BOUT  B AW1 T", "A42128  EY1 F AO1 R", "D'ARTAGNAN  D AH0"]
    path.write_text("\n".join(lines) + "\n", encoding="latin-1")
    return path


@pytest.mark.parametrize("seed", [0, 3])
def test_make_cmudict_eval_writes_the_jax_bytes(tmp_path, monkeypatch, seed):
    cmu = _cmudict(tmp_path / "cmudict-0.7b", seed)
    flags = ["--cmudict", cmu, "--seed", seed, "--n-lexicon", 20,
             "--n-morph", 10, "--n-oov", 10]
    _run_both(monkeypatch, "make_cmudict_eval.py", "make_cmudict_eval",
              flags + ["--out", tmp_path / "jax.txt"],
              flags + ["--out", tmp_path / "port.txt"])
    port = (tmp_path / "port.txt").read_text(encoding="utf-8")
    assert port == (tmp_path / "jax.txt").read_text(encoding="utf-8")
    rows = [r.split("|") for r in port.splitlines()
            if not r.startswith("#")]
    assert {r[0] for r in rows} == {"lexicon", "morph", "oov"}
    assert len(rows) == 40
