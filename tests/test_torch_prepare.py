"""The port's corpus legs against the JAX package's, on the CPU: the dataset
combinators and audio datasets (``data/dataset.py``, ``data/datasets.py``)
on the same indices, and each recipe's ``preprocess.py`` and
``normalize.py`` on the same corpus, the JAX CLI run in this process
(``sys.argv`` patched; its shims through ``runpy``) and the port's through
``main(argv)``.

The corpus is tests/test_chain.py's: six sine wavs at 24 kHz with noise
from numpy seed 0 and a durations file of two speakers, and the same wavs
as an LJSpeech tree (``metadata.csv``) for the TransformerTTS and
Tacotron2 legs.  Held bit for bit (both sides are numpy copies of one
pipeline): the metadata rows (their paths mapped from one dump directory
to the other), the id maps, every ``.npy`` the CLIs write, the
statistics files.  ``--num-cpu 1`` throughout; TransformerTTS's default
``--frontend phone`` needs g2p_en and skips without it, as the JAX tests
skip it.
"""
import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import parakeet_tpu.data.dataset as jds
import parakeet_tpu.data.datasets as jdatasets
from parakeet_tpu.audio.codec import save_wav
from parakeet_tpu_torch.data import dataset as tds
from parakeet_tpu_torch.data import datasets as tdatasets
from parakeet_tpu_torch.recipes.fastspeech2 import normalize as fs2_norm
from parakeet_tpu_torch.recipes.fastspeech2 import preprocess as fs2_pre
from parakeet_tpu_torch.recipes.pwgan import normalize as pwg_norm
from parakeet_tpu_torch.recipes.pwgan import preprocess as pwg_pre
from parakeet_tpu_torch.recipes.speedyspeech import normalize as ss_norm
from parakeet_tpu_torch.recipes.speedyspeech import preprocess as ss_pre
from parakeet_tpu_torch.recipes.tacotron2 import normalize as t2_norm
from parakeet_tpu_torch.recipes.tacotron2 import preprocess as t2_pre
from parakeet_tpu_torch.recipes.transformer_tts import \
    normalize as tts_norm
from parakeet_tpu_torch.recipes.transformer_tts import \
    preprocess as tts_pre
from parakeet_tpu_torch.recipes.waveflow import preprocess as wf_pre

ROOT = Path(__file__).resolve().parents[1]
HAS_G2P_EN = importlib.util.find_spec("g2p_en") is not None
TINY_YAML = """\
fs: 24000
n_fft: 512
n_shift: 300
win_length: 512
fmin: 80
fmax: 7600
n_mels: 20
f0min: 80
f0max: 400
"""
LJ_TEXT = ["Printing, in the only sense.", "With which we are at present",
           "concerned, differs from most", "if not from all the arts",
           "and crafts represented", "in the Exhibition."]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_chain.py's corpus (six wavs, durations of two speakers,
    numpy seed 0), its audio YAML, and the wavs as an LJSpeech tree."""
    root = tmp_path_factory.mktemp("corpus")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    sr, hop = 24000, 300
    phones = ["sil", "b", "a1", "sp", "m", "i2", "sil"]
    lines = []
    lj = root / "lj"
    (lj / "wavs").mkdir(parents=True)
    csv = []
    for i in range(6):
        n_frames = 40 + 8 * i
        t = np.arange(n_frames * hop) / sr
        f0 = 120 + 20 * i
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        utt = f"utt{i:03d}"
        save_wav(wavs / f"{utt}.wav", wav, sr)
        save_wav(lj / "wavs" / f"LJ001-{i:04d}.wav", wav, sr)
        durs = np.full(len(phones), n_frames // len(phones), np.int64)
        durs[-1] += n_frames - durs.sum()
        pd = " ".join(f"{p} {d}" for p, d in zip(phones, durs))
        lines.append(f"{utt}|spk{i % 2}|{pd}")
        csv.append(f"LJ001-{i:04d}|{LJ_TEXT[i].upper()}|{LJ_TEXT[i]}")
    (root / "durations.txt").write_text("\n".join(lines) + "\n")
    (lj / "metadata.csv").write_text("\n".join(csv) + "\n")
    (root / "tiny.yaml").write_text(TINY_YAML)
    return root


def _run_jax(monkeypatch, script, argv):
    """Run ``recipes/<script>`` as ``__main__`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [script] + [str(a) for a in argv])
    runpy.run_path(str(ROOT / "recipes" / script), run_name="__main__")


def _files(d):
    return sorted(p.name for p in Path(d).iterdir() if p.is_file())


def _same_dumps(jax_dir, port_dir, sides=("jax", "port")):
    """Every file of the two dump directories: the same names, each .npy
    bit for bit, every other file the same text once each side's root
    (``<tmp>/<side>``, a prefix of every path it wrote) is swapped for a
    placeholder."""
    jax_dir, port_dir = Path(jax_dir), Path(port_dir)
    assert _files(jax_dir) == _files(port_dir) and _files(jax_dir)
    roots = [str(d).rsplit(f"/{side}", 1)[0] + f"/{side}"
             for d, side in zip((jax_dir, port_dir), sides)]
    for name in _files(jax_dir):
        a, b = jax_dir / name, port_dir / name
        if name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert (a.read_text().replace(roots[0], "<side>")
                    == b.read_text().replace(roots[1], "<side>")), name


@pytest.mark.parametrize("name", ["split", "TransformDataset",
                                  "CacheDataset", "TupleDataset",
                                  "DictDataset", "SliceDataset",
                                  "SubsetDataset", "FilterDataset",
                                  "ChainDataset"])
def test_dataset_combinators_match_jax(name):
    """Each combinator over the same lists gives the same length and the
    same example at every index (negative ones where JAX takes them), and
    refuses what JAX refuses with the same exception type."""
    rng = np.random.default_rng(1)
    a = [rng.standard_normal(2).tolist() for _ in range(7)]
    b = [int(v) for v in rng.integers(0, 9, 7)]

    def build(mod):
        return {
            "split": lambda: mod.split(a, 3),
            "TransformDataset": lambda: mod.TransformDataset(
                a, lambda x: [v * 2 for v in x]),
            "CacheDataset": lambda: mod.CacheDataset(a),
            "TupleDataset": lambda: mod.TupleDataset(a, b),
            "DictDataset": lambda: mod.DictDataset(x=a, y=b),
            "SliceDataset": lambda: mod.SliceDataset(a, 2, 6),
            "SubsetDataset": lambda: mod.SubsetDataset(a, [6, 0, 3]),
            "FilterDataset": lambda: mod.FilterDataset(b, lambda v: v > 3),
            "ChainDataset": lambda: mod.ChainDataset(a, b, a[:2]),
        }[name]()

    want, got = build(jds), build(tds)
    pairs = list(zip(want, got)) if name == "split" else [(want, got)]
    for w, g in pairs:
        assert len(w) == len(g)
        idx = list(range(len(w)))
        if name == "SliceDataset":
            idx += [-1, -len(w)]
        for i in idx:
            assert w[i] == g[i]
            assert g[i] == g[i]            # a cache hands back the same
    bad = {"split": lambda m: m.split(a, 7),
           "TupleDataset": lambda m: m.TupleDataset(a, b[:3]),
           "DictDataset": lambda m: m.DictDataset(x=a, y=b[:3]),
           "SliceDataset": lambda m: m.SliceDataset(a, 0, 8),
           "SubsetDataset": lambda m: m.SubsetDataset(a[:2], [0, 1, 1]),
           "ChainDataset": lambda m: m.ChainDataset(a)[-1]}.get(name)
    if bad is not None:
        with pytest.raises(Exception) as jerr:
            bad(jds)
        with pytest.raises(jerr.type):
            bad(tds)


def test_audio_datasets_match_jax(corpus):
    """AudioDataset (trimmed at 20 dB, volume-normalized), its random
    segments from the same seed (clips shorter and longer than a file),
    the folder dataset and LJSpeech's metadata: the same examples, bit for
    bit."""
    paths = sorted((corpus / "wavs").glob("*.wav"))
    kw = dict(sample_rate=24000, volume_normalize=True, trim_db=20.0)
    pairs = [(jdatasets.AudioDataset(paths, **kw),
              tdatasets.AudioDataset(paths, **kw)),
             (jdatasets.AudioFolderDataset(corpus / "wavs"),
              tdatasets.AudioFolderDataset(corpus / "wavs"))]
    for n in (5000, 30000):
        pairs.append((jdatasets.AudioSegmentDataset(paths, n, seed=3, **kw),
                      tdatasets.AudioSegmentDataset(paths, n, seed=3, **kw)))
    for want, got in pairs:
        assert len(want) == len(got) == 6
        for i in range(6):
            w, g = want[i], got[i]
            assert w.dtype == g.dtype and np.array_equal(w, g)
    meta = (jdatasets.LJSpeechMetaData(corpus / "lj"),
            tdatasets.LJSpeechMetaData(corpus / "lj"))
    assert len(meta[0]) == len(meta[1]) == 6
    assert [meta[0][i] for i in range(6)] == [meta[1][i] for i in range(6)]


def _pwg_argv(corpus, dump, cut):
    argv = ["--rootdir", corpus / "wavs", "--dumpdir", dump, "--config",
            corpus / "tiny.yaml", "--dev-size", "2", "--num-cpu", "1"]
    if cut:
        argv += ["--dur-file", corpus / "durations.txt", "--cut-sil"]
    return argv


@pytest.mark.parametrize("cli", ["pwgan", "waveflow"])
@pytest.mark.parametrize("cut", [False, True])
def test_vocoder_preprocess_and_normalize_match_jax(corpus, tmp_path,
                                                    monkeypatch, cli, cut):
    """PWGAN's (and WaveFlow's, which runs it) (wave, log-mel) dumps with
    and without ``--dur-file --cut-sil``, then the train split's
    statistics and both splits normalized (dev reusing them, with and
    without the wave copy): every file bit for bit."""
    port_main = {"pwgan": pwg_pre.main, "waveflow": wf_pre.main}[cli]
    _run_jax(monkeypatch, f"{cli}/preprocess.py",
             _pwg_argv(corpus, tmp_path / "jax", cut))
    rows = port_main([str(a) for a in _pwg_argv(corpus, tmp_path / "port",
                                                 cut)])
    assert len(rows) == 6
    _same_dumps(tmp_path / "jax", tmp_path / "port")
    for side in ("jax", "port"):
        for split, extra in (("train", ["--compute-stats"]),
                             ("dev", ["--skip-wav-copy"])):
            argv = ["--metadata", tmp_path / side / f"metadata_{split}.jsonl",
                    "--dumpdir", tmp_path / f"{side}_norm" / split,
                    "--stats", tmp_path / f"{side}_norm" / "feats_stats.npy",
                    *extra]
            if side == "jax":
                _run_jax(monkeypatch, "pwgan/normalize.py", argv)
            else:
                pwg_norm.main([str(a) for a in argv])
    _same_dumps(tmp_path / "jax_norm", tmp_path / "port_norm")
    for split in ("train", "dev"):
        _same_dumps(tmp_path / "jax_norm" / split,
                    tmp_path / "port_norm" / split)


def test_vocoder_normalize_refuses_missing_stats(tmp_path, corpus):
    """The dev split before the train split's statistics: SystemExit, as
    in JAX, in each normalize."""
    pwg_pre.main([str(a) for a in _pwg_argv(corpus, tmp_path / "d", False)])
    md = str(tmp_path / "d" / "metadata_dev.jsonl")
    with pytest.raises(SystemExit, match="--compute-stats"):
        pwg_norm.main(["--metadata", md, "--dumpdir", str(tmp_path / "n"),
                       "--stats", str(tmp_path / "none.npy")])
    with pytest.raises(SystemExit, match="--compute-stats"):
        ss_norm.main(["--metadata", md, "--dumpdir", str(tmp_path / "n"),
                      "--stats-dir", str(tmp_path / "none")])


def _am_argv(corpus, dump):
    return ["--rootdir", corpus / "wavs", "--duration-file",
            corpus / "durations.txt", "--dumpdir", dump, "--config",
            corpus / "tiny.yaml", "--dev-size", "1", "--test-size", "2",
            "--num-cpu", "1"]


def _normalize_both(monkeypatch, tmp_path, script, port_main, extra,
                    key="speech"):
    """The JAX CLI and the port's on each split of their own dumps, the
    train split first with --compute-stats, into <side>_norm/."""
    for side in ("jax", "port"):
        for split in ("train", "dev", "test"):
            argv = ["--metadata", tmp_path / side / f"metadata_{split}.jsonl",
                    "--dumpdir", tmp_path / f"{side}_norm" / split,
                    "--stats-dir", tmp_path / f"{side}_norm", *[
                        tmp_path / side / a if a.endswith(".txt") else a
                        for a in extra]]
            if split == "train":
                argv.append("--compute-stats")
            if side == "jax":
                _run_jax(monkeypatch, script, argv)
            else:
                port_main([str(a) for a in argv])


@pytest.mark.parametrize("speakers", [False, True])
def test_fastspeech2_preprocess_and_normalize_match_jax(
        corpus, tmp_path, monkeypatch, speakers):
    """Mel, token-averaged pitch (YIN where pyworld is missing) and
    energy, the three splits in utt_id order and the phone and speaker
    maps; then the three statistics and every split normalized with phone
    ids (and, with ``--speaker-dict``, speaker ids): bit for bit."""
    _run_jax(monkeypatch, "fastspeech2/preprocess.py",
             _am_argv(corpus, tmp_path / "jax"))
    rows = fs2_pre.main([str(a) for a in _am_argv(corpus, tmp_path / "port")])
    assert [r["utt_id"] for r in rows] == [f"utt{i:03d}" for i in range(6)]
    _same_dumps(tmp_path / "jax", tmp_path / "port")
    extra = ["--phones-dict", "phone_id_map.txt"]
    if speakers:
        extra += ["--speaker-dict", "speaker_id_map.txt"]
    _normalize_both(monkeypatch, tmp_path, "fastspeech2/normalize.py",
                    fs2_norm.main, extra)
    _same_dumps(tmp_path / "jax_norm", tmp_path / "port_norm")
    for split in ("train", "dev", "test"):
        _same_dumps(tmp_path / "jax_norm" / split,
                    tmp_path / "port_norm" / split)
    row = (tmp_path / "port_norm" / "train" / "metadata.jsonl").read_text()
    assert ('"spk_id"' in row) == speakers and '"text"' in row


def test_preprocess_in_worker_processes_is_the_same(corpus, tmp_path):
    """``--num-cpu 2`` (spawned workers) writes the dump that one process
    writes, bit for bit."""
    rows = [fs2_pre.main([str(a) for a in _am_argv(corpus, tmp_path / d)[
        :-2] + ["--num-cpu", n]]) for d, n in (("one", "1"), ("two", "2"))]
    assert len(rows[0]) == len(rows[1]) == 6
    _same_dumps(tmp_path / "one", tmp_path / "two", ("one", "two"))


def test_speedyspeech_preprocess_and_normalize_match_jax(corpus, tmp_path,
                                                         monkeypatch):
    """Mel and the phone and tone ids split off the pinyin finals (``a1``
    -> ``a`` + ``1``), the phone and tone maps, the splits; then the mel
    statistics and every split normalized: bit for bit."""
    _run_jax(monkeypatch, "speedyspeech/preprocess.py",
             _am_argv(corpus, tmp_path / "jax"))
    rows = ss_pre.main([str(a) for a in _am_argv(corpus, tmp_path / "port")])
    assert len(rows) == 6 and {t for r in rows for t in r["tones"]} > {0}
    assert ss_pre.split_phone_tone("ang4") == ("ang", "4")
    _same_dumps(tmp_path / "jax", tmp_path / "port")
    _normalize_both(monkeypatch, tmp_path, "speedyspeech/normalize.py",
                    ss_norm.main, [])
    _same_dumps(tmp_path / "jax_norm", tmp_path / "port_norm")
    for split in ("train", "dev", "test"):
        _same_dumps(tmp_path / "jax_norm" / split,
                    tmp_path / "port_norm" / split)


def _lj_argv(corpus, dump, *frontend):
    return ["--rootdir", corpus / "lj", "--dumpdir", dump, "--config",
            corpus / "tiny.yaml", "--dev-size", "1", "--test-size", "1",
            "--num-cpu", "1", *frontend]


@pytest.mark.parametrize("recipe,frontend", [
    ("transformer_tts", "char"), ("transformer_tts", "phone"),
    ("tacotron2", None)])
def test_ar_preprocess_and_normalize_match_jax(corpus, tmp_path,
                                               monkeypatch, recipe,
                                               frontend):
    """LJSpeech's normalized text as characters (``<sp>`` at word
    boundaries; Tacotron2's default, through its shim) or ARPABET phones
    (g2p_en), the <pad>/<unk>/<eos> map, the mels and the splits in the
    csv's order; then the speech statistics and every split normalized
    with token ids (Tacotron2's normalize is TransformerTTS's): bit for
    bit."""
    if frontend == "phone" and not HAS_G2P_EN:
        pytest.skip("the ARPABET frontend needs g2p_en (not installed)")
    flag = [] if frontend is None else ["--frontend", frontend]
    pre = {"transformer_tts": tts_pre.main, "tacotron2": t2_pre.main}
    norm = {"transformer_tts": tts_norm.main, "tacotron2": t2_norm.main}
    _run_jax(monkeypatch, f"{recipe}/preprocess.py",
             _lj_argv(corpus, tmp_path / "jax", *flag))
    rows = pre[recipe]([str(a) for a in _lj_argv(corpus, tmp_path / "port",
                                                  *flag)])
    assert [r["utt_id"] for r in rows] == [f"LJ001-{i:04d}"
                                            for i in range(6)]
    if frontend != "phone":
        assert "<sp>" in rows[0]["phones"]
    _same_dumps(tmp_path / "jax", tmp_path / "port")
    _normalize_both(monkeypatch, tmp_path, f"{recipe}/normalize.py",
                    norm[recipe], ["--phones-dict", "phone_id_map.txt"])
    _same_dumps(tmp_path / "jax_norm", tmp_path / "port_norm")
    for split in ("train", "dev", "test"):
        _same_dumps(tmp_path / "jax_norm" / split,
                    tmp_path / "port_norm" / split)
