"""The port's text frontends against the JAX package's, on the CPU: every
line of the five case files under recipes/text_frontend/data gives the
same normalized text, syllables, phones and ids in both packages (the
Chinese ones with jieba's segmentation and without it, the path a machine
without jieba takes), the text-frontend harnesses' corpus CER/WER equal
with either package's classes, ``ARPABET(WithStress)``,
``ParakeetPinyin(WithTone)``, ``English`` and ``EnglishCharacter`` on the
same sentences, the CLIs' ``build_text_to_ids`` for zh, en and en-char,
and the data tables copied verbatim.  Everything is exact: the frontends
are pure Python.
"""
import importlib
import importlib.util
from pathlib import Path

import pytest

import parakeet_tpu.frontend as jfe
import parakeet_tpu.frontend.cli as jcli
import parakeet_tpu_torch.frontend as tfe
from parakeet_tpu.frontend import tone_sandhi as j_sandhi
from parakeet_tpu.frontend import zh_frontend as j_zh
from parakeet_tpu_torch.frontend import tone_sandhi as t_sandhi
from parakeet_tpu_torch.frontend import zh_frontend as t_zh
from parakeet_tpu_torch.recipes.synthesis import write_id_maps

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "recipes" / "text_frontend" / "data"
PACKAGES = (jfe, tfe)
EN_CHARS = "abcdefghijklmnopqrstuvwxyz'.,?!-"
SENTENCES = ("今天天气很好，我们一起去公园散步吧。",
             "2024年3月15日下午3点，气温是-5°C，电话13812345678。",
             "小院儿里的花儿开了，一不小心摔了一跤。")
EN_SENTENCES = ("Hello world, this is a test.",
                "Dr. Smith paid $3.50 for 2 apples on Jan. 5th!",
                "I can't believe it's the 21st century -- isn't it?")


def _cases(name):
    """The (left, right) of each ``left|right`` line of a case file."""
    out = []
    for line in (DATA / name).read_text(encoding="utf-8").splitlines():
        if line and not line.startswith("#") and "|" in line:
            out.append(tuple(line.split("|")[:2]))
    assert out, name
    return out


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    zh, en = write_id_maps(d / "zh", "zh"), write_id_maps(d / "en", "en")
    chars = d / "chars.txt"
    chars.write_text("".join(f"{c} {i}\n" for i, c in enumerate(
        ["<pad>", "<sp>"] + list(EN_CHARS))))
    return {"zh": zh, "en": en, "chars": chars}


def _without_jieba(monkeypatch):
    """The path without jieba in both packages: the whole sentence one
    word, no word splitting in the sandhi."""
    for zh, sandhi in ((j_zh, j_sandhi), (t_zh, t_sandhi)):
        monkeypatch.setattr(zh, "_HAS_JIEBA", False)
        monkeypatch.setattr(zh, "psg", None)
        monkeypatch.setattr(sandhi, "_HAS_JIEBA", False)
        monkeypatch.setattr(sandhi, "jieba", None)


@pytest.fixture(params=["jieba", "no_jieba"])
def segmentation(request, monkeypatch):
    """jieba's segmentation, or the path without jieba, in both
    packages."""
    if request.param == "no_jieba":
        _without_jieba(monkeypatch)
    else:
        assert j_zh._HAS_JIEBA and t_zh._HAS_JIEBA
    return request.param


def test_textnorm_cases_match():
    """``TextNormalizer.normalize`` on every raw line of
    textnorm_test_cases.txt (and its label): the same sub-sentences."""
    jn, tn = jfe.TextNormalizer(), tfe.TextNormalizer()
    for raw, label in _cases("textnorm_test_cases.txt"):
        for text in (raw, label):
            assert tn.normalize(text) == jn.normalize(text), text


def test_zh_g2p_cases_match(segmentation, maps):
    """Every sentence of g2p_test_cases.txt (and a few with numbers, dates
    and erhua): syllables, phones, phone ids (the FastSpeech2 map) and
    phone and tone ids (the SpeedySpeech maps) identical."""
    zh = maps["zh"]
    plain = [m.Frontend(phone_vocab_path=str(zh["phones"]), strict=False)
             for m in PACKAGES]
    toned = [m.Frontend(phone_vocab_path=str(zh["tone_phones"]),
                        tone_vocab_path=str(zh["tones"]), strict=False)
             for m in PACKAGES]
    assert type(plain[1].g2p).__name__ == type(plain[0].g2p).__name__
    sentences = [s for s, _ in _cases("g2p_test_cases.txt")]
    assert len(sentences) >= 200
    empty = 0
    for s in sentences + list(SENTENCES):
        want = plain[0].get_input_ids(s)
        assert plain[1].get_input_ids(s) == want, s
        assert toned[1].get_input_ids(s) == toned[0].get_input_ids(s), s
        assert plain[1].get_syllables(s) == plain[0].get_syllables(s), s
        empty += not want["phone_ids"]
    assert empty == 0


def test_en_textnorm_cases_match():
    for raw, label in _cases("en_textnorm_test_cases.txt"):
        for text in (raw, label):
            assert tfe.normalize_en(text) == jfe.normalize_en(text), text


@pytest.mark.parametrize("name", ["en_g2p_test_cases.txt",
                                  "en_g2p_cmudict_cases.txt"])
def test_en_g2p_cases_match(name):
    """``English``, ``ARPABET`` and ``ARPABETWithStress``: phones and ids
    of every sentence (or word) of the English case files identical, and
    ``reverse`` maps the ids back."""
    lines = _cases(name)
    if name.startswith("en_g2p_cmudict"):
        lines = [(word, None) for _, word in lines]   # stratum|word|refs
    pairs = [(getattr(jfe, c)(), getattr(tfe, c)())
             for c in ("English", "ARPABET", "ARPABETWithStress")]
    for j, t in pairs:
        assert t.vocab.stoi == j.vocab.stoi
    for text, _ in lines:
        for j, t in pairs:
            phones = t.phoneticize(text)
            assert phones == j.phoneticize(text), text
            ids = t.numericalize(phones)
            assert ids == j.numericalize(phones), text
            assert t.reverse(ids) == j.reverse(ids)


def _harness(name):
    spec = importlib.util.spec_from_file_location(
        f"text_frontend_{name}", ROOT / "recipes" / "text_frontend"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,classes,args", [
    ("test_textnorm", ("TextNormalizer",), ()),
    ("test_g2p", ("Frontend",), ()),
    ("test_en_textnorm", ("normalize",), ()),
    ("test_en_g2p", ("ARPABET", "ARPABETWithStress"), (False,)),
    ("test_en_g2p", ("ARPABET", "ARPABETWithStress"), (True,)),
    ("test_en_g2p_cmudict", ("ARPABET", "ARPABETWithStress"), (False,)),
    ("test_en_g2p_cmudict", ("ARPABET", "ARPABETWithStress"), (True,))])
def test_corpus_error_rates_equal(name, classes, args, monkeypatch):
    """Each harness of recipes/text_frontend (its default data) scores the
    port's classes exactly as the JAX package's: the same corpus CER or
    WER (by stratum for the CMUdict set) over the same lines."""
    mod = _harness(name)
    want = mod.corpus_wer(mod.DEFAULT_DATA, *args) if hasattr(
        mod, "corpus_wer") else mod.corpus_cer(mod.DEFAULT_DATA)
    for cls in classes:
        port = getattr(tfe, "normalize_en" if cls == "normalize" else cls)
        assert getattr(mod, cls).__module__.startswith("parakeet_tpu.")
        monkeypatch.setattr(mod, cls, port)
    got = mod.corpus_wer(mod.DEFAULT_DATA, *args) if hasattr(
        mod, "corpus_wer") else mod.corpus_cer(mod.DEFAULT_DATA)
    assert got == want


def test_pinyin_and_english_phonetics():
    """``ParakeetPinyin(WithTone)``, ``English`` and ``EnglishCharacter``:
    the same vocabularies, phones, ids and reversed symbols."""
    for cls, sentences in (("ParakeetPinyin", SENTENCES),
                           ("ParakeetPinyinWithTone", SENTENCES),
                           ("English", EN_SENTENCES),
                           ("EnglishCharacter", EN_SENTENCES)):
        j, t = getattr(jfe, cls)(), getattr(tfe, cls)()
        assert t.vocab.stoi == j.vocab.stoi and t.vocab_size == j.vocab_size
        for s in sentences:
            phones = t.phoneticize(s)
            assert phones and phones == j.phoneticize(s), (cls, s)
            ids = t(s)
            assert ids == j(s) == t.numericalize(phones), (cls, s)
            assert t.reverse(ids) == j.reverse(ids)


@pytest.mark.parametrize("lang,jieba", [("zh", True), ("zh", False),
                                        ("en", None), ("en-char", None)])
def test_build_text_to_ids(lang, jieba, maps, monkeypatch):
    """The CLIs' sentence -> ids on the case files' sentences of ``lang``
    with the matching phone map (zh with and without jieba)."""
    path = {"zh": maps["zh"]["phones"], "en": maps["en"]["phones"],
            "en-char": maps["chars"]}[lang]
    if lang == "zh":
        if not jieba:
            _without_jieba(monkeypatch)
        sentences = [s for s, _ in _cases("g2p_test_cases.txt")[:40]]
    else:
        sentences = [s for s, _ in _cases("en_g2p_test_cases.txt")]
    want = jcli.build_text_to_ids(lang, path)
    got = tfe.build_text_to_ids(lang, path)
    for s in sentences + list(SENTENCES if lang == "zh" else EN_SENTENCES):
        ids = got(s)
        assert ids and ids == want(s), s
    with pytest.raises(ValueError, match="unsupported lang"):
        tfe.build_text_to_ids("fr", path)


@pytest.mark.parametrize("module", [
    "frontend._arpabet_data", "frontend._pinyin_data", "frontend._sandhi_data",
    "frontend.zh_normalization._char_convert_data"])
def test_data_tables_equal(module):
    """Every table of the copied data modules (``BUILTIN_LEXICON``,
    ``WORD_PINYIN``, ``CHAR_PINYIN_EXTRA``, the sandhi word sets, the
    character strings, ...) equals the JAX package's."""
    j = importlib.import_module(f"parakeet_tpu.{module}")
    t = importlib.import_module(f"parakeet_tpu_torch.{module}")

    def tables(m):
        return {k: v for k, v in vars(m).items()
                if k.isupper() and not k.startswith("_")}

    assert tables(t) and tables(t).keys() == tables(j).keys()
    for name, value in tables(j).items():
        assert tables(t)[name] == value, name
    assert t_zh._BUILTIN_PINYIN == j_zh._BUILTIN_PINYIN
