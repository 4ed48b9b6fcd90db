"""The port's corpus preprocessing helpers (``data/preprocess.py``) and
TextGrid durations (``data/textgrid.py``) against the JAX package's, on
the CPU: every function on seeded inputs (numpy) and on MFA TextGrids
that the test writes, bit for bit (the same files, lists and arrays; the
running statistics' float64 sums in the same order).
"""
import copy

import numpy as np
import pytest

from parakeet_tpu.data import preprocess as jpre
from parakeet_tpu.data import textgrid as jtg
from parakeet_tpu_torch.data import preprocess as tpre
from parakeet_tpu_torch.data import textgrid as ttg

PHONES = ["sil", "sp", "n", "i3", "h", "ao3", "zh", "ong1", "AH0", "B",
          "er2", "spl"]


def _sentences(seed, n=6):
    """{utt: [phones, durations, speaker]} with runs of sil/sp at the edges
    and inside, long and short pauses."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        k = int(rng.integers(3, 12))
        phones = ["sil"] + list(rng.choice(PHONES, k)) + ["sp", "sil"]
        durs = rng.integers(1, 25, len(phones)).tolist()
        out[f"utt{i}"] = [phones, durs, f"spk{i % 3}"]
    return out


def _duration_file(path, sentences):
    path.write_text("".join(
        f"{utt}|{spk}|" + " ".join(f"{p} {d}" for p, d in zip(ph, du))
        + "\n" for utt, (ph, du, spk) in sentences.items()) + "\n")
    return path


def test_read_duration_file_and_merge_silence(tmp_path):
    path = _duration_file(tmp_path / "durations.txt", _sentences(0))
    want, want_spk = jpre.read_duration_file(path)
    got, got_spk = tpre.read_duration_file(path)
    assert got == want and got_spk == want_spk
    for thr in (14, 5):
        a, b = copy.deepcopy(want), copy.deepcopy(got)
        jpre.merge_silence(a, thr)
        tpre.merge_silence(b, thr)
        assert b == a
    (tmp_path / "odd.txt").write_text("u|s|a 1 b\n")
    for mod in (jpre, tpre):
        with pytest.raises(ValueError, match="odd phone/dur"):
            mod.read_duration_file(tmp_path / "odd.txt")


@pytest.mark.parametrize("edges", [("sil", "sil"), ("a", "sil"),
                                   ("sil", "b"), ("sil",)])
def test_cut_silence(edges):
    rng = np.random.default_rng(1)
    phones = [edges[0]] + ["x", "y"] * (len(edges) > 1) + list(edges[1:])
    durs = rng.integers(1, 9, len(phones)).tolist()
    wav = rng.standard_normal(sum(durs) * 4).astype(np.float32)
    w_wav, w_ph, w_du = jpre.cut_silence(wav, phones, durs, 4)
    g_wav, g_ph, g_du = tpre.cut_silence(wav, phones, durs, 4)
    assert np.array_equal(g_wav, w_wav) and g_wav.dtype == w_wav.dtype
    assert (g_ph, g_du) == (w_ph, w_du)


@pytest.mark.parametrize("dataset", ["baker", "ljspeech"])
def test_id_maps(tmp_path, dataset):
    """The phone, phone/tone and speaker maps written identically, and read
    back by ``load_id_map``."""
    sentences = _sentences(2)
    for mod, d in ((jpre, tmp_path / "jax"), (tpre, tmp_path / "port")):
        d.mkdir()
        mod.build_phone_id_map(sentences, d / "phones.txt", dataset)
        mod.build_phone_tone_id_maps(sentences, d / "tone_phones.txt",
                                     d / "tones.txt", dataset)
        mod.build_spk_id_map({s for *_, s in sentences.values()},
                             d / "spk.txt")
    for name in ("phones.txt", "tone_phones.txt", "tones.txt", "spk.txt"):
        want = (tmp_path / "jax" / name).read_text()
        assert (tmp_path / "port" / name).read_text() == want
        assert tpre.load_id_map(tmp_path / "port" / name) == \
            jpre.load_id_map(tmp_path / "jax" / name)


def test_reconcile_durations():
    """Longer, shorter (absorbed by the last token, then the first) and
    impossible frame counts; an unknown utterance."""
    base = {"a": [["x", "y", "z"], [3, 4, 2], "s"]}
    for n in (9, 12, 8, 7, 3, 1):
        a, b = copy.deepcopy(base), copy.deepcopy(base)
        assert tpre.reconcile_durations(b, "a", n) == \
            jpre.reconcile_durations(a, "a", n)
        assert b == a
    assert tpre.reconcile_durations({}, "a", 5) is False


def test_running_stats(tmp_path):
    """Batches of varied sizes (one empty, one a 1-D row): mean, std,
    ``save`` and ``load`` bit for bit; a single row has unit std."""
    rng = np.random.default_rng(3)
    j, t = jpre.RunningStats(5), tpre.RunningStats(5)
    assert np.array_equal(t.std, j.std)
    for m in (7, 0, 1, 33, 2):
        x = rng.standard_normal((m, 5)) * 3 + 1
        j.update(x)
        t.update(x)
    one_j, one_t = jpre.RunningStats(1), tpre.RunningStats(1)
    row = rng.standard_normal(4)
    one_j.update(row)
    one_t.update(row)
    for a, b in ((j, t), (one_j, one_t)):
        assert b.n == a.n
        assert np.array_equal(b.mean, a.mean) and np.array_equal(b.std,
                                                                  a.std)
    j.save(tmp_path / "j.npy")
    t.save(tmp_path / "t.npy")
    assert (tmp_path / "t.npy").read_bytes() == \
        (tmp_path / "j.npy").read_bytes()
    for x, y in zip(tpre.RunningStats.load(tmp_path / "t.npy"),
                    jpre.RunningStats.load(tmp_path / "j.npy")):
        assert np.array_equal(x, y)


def _textgrid(intervals, tier="phones", xmax=None):
    """An MFA long-format TextGrid with a words tier and ``tier``."""
    xmax = xmax or intervals[-1][1]
    body = []
    for i, (name, items) in enumerate(
            (("words", [(0.0, xmax, "hello")]), (tier, intervals)), 1):
        body.append(f'    item [{i}]:\n        class = "IntervalTier"\n'
                    f'        name = "{name}"\n        xmin = 0\n'
                    f'        xmax = {xmax}\n'
                    f'        intervals: size = {len(items)}\n')
        for k, (a, b, label) in enumerate(items, 1):
            body.append(f'        intervals [{k}]:\n'
                        f'            xmin = {a}\n            xmax = {b}\n'
                        f'            text = "{label}"\n')
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f'xmin = 0\nxmax = {xmax}\ntiers? <exists>\nsize = 2\n'
            'item []:\n' + "".join(body))


def _random_intervals(rng, labels):
    ends = np.cumsum(rng.uniform(0.01, 0.3, len(labels)))
    starts = np.concatenate([[0.0], ends[:-1]])
    return [(round(float(a), 4), round(float(b), 4), lab)
            for a, b, lab in zip(starts, ends, labels)]


def test_textgrid_durations(tmp_path):
    """``parse_textgrid``, ``textgrid_to_durations`` (the MFA fixes: edge
    and inner empty labels, a trailing "" after sp, a final sp, quoted
    quotes) and ``gen_duration_from_textgrid`` over a speaker tree, at two
    frame rates."""
    rng = np.random.default_rng(4)
    cases = [["", "n", "i3", "", "h", "ao3", "sp", ""],
             ["sil", "AH0", "B", "sp"],
             ["", 'q""t', "er2", ""],
             ["zh", "ong1"]]
    root = tmp_path / "mfa"
    for i, labels in enumerate(cases):
        d = root / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"utt{i}.TextGrid").write_text(
            _textgrid(_random_intervals(rng, labels)), encoding="utf-8")
    for tg in sorted(root.rglob("*.TextGrid")):
        assert ttg.parse_textgrid(tg) == jtg.parse_textgrid(tg)
        for sr, hop in ((24000, 300), (22050, 256)):
            assert ttg.textgrid_to_durations(tg, sr, hop) == \
                jtg.textgrid_to_durations(tg, sr, hop)
        for mod in (jtg, ttg):
            with pytest.raises(KeyError, match="tier 'syllables'"):
                mod.textgrid_to_durations(tg, tier="syllables")
    jtg.gen_duration_from_textgrid(root, tmp_path / "j.txt", 22050, 256)
    ttg.gen_duration_from_textgrid(root, tmp_path / "t.txt", 22050, 256)
    want = (tmp_path / "j.txt").read_text()
    assert (tmp_path / "t.txt").read_text() == want
    assert len(want.splitlines()) == len(cases)
    # the file reads back as a duration file
    assert tpre.read_duration_file(tmp_path / "t.txt") == \
        jpre.read_duration_file(tmp_path / "j.txt")
