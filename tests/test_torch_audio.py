"""The port's copies of the framework-free host code against the JAX
package's originals, bit for bit (both are numpy, scipy or pure Python):
``audio/`` (STFT and ISTFT, the mel filterbank and scale, Griffin-Lim,
``LogMelFBank`` in both bases, YIN ``Pitch``, ``Energy``,
``average_by_duration``, the normalizers, mu-law and quantize, the wav
codec with resampling, ``formant_utterance``), ``utils/mp_tools``'s
``thread_map`` and the frontend's ``generate_lexicon`` and ``Vocab``.
The pyworld and soundfile paths skip where their package is missing."""
import importlib.util

import numpy as np
import pytest

import parakeet_tpu.audio as jaudio
from parakeet_tpu.audio import codec as jcodec
from parakeet_tpu.audio import features as jfeatures
from parakeet_tpu.audio import spectrum as jspectrum
from parakeet_tpu.audio import synthetic as jsynthetic
from parakeet_tpu.frontend.generate_lexicon import \
    generate_lexicon as j_lexicon
from parakeet_tpu.frontend.generate_lexicon import \
    split_syllable as j_split
from parakeet_tpu.frontend.vocab import Vocab as JVocab
import parakeet_tpu_torch.audio as taudio
from parakeet_tpu_torch.audio import codec, features, spectrum, synthetic
from parakeet_tpu_torch.frontend import Vocab, generate_lexicon
from parakeet_tpu_torch.frontend.generate_lexicon import split_syllable
from parakeet_tpu_torch.utils.mp_tools import thread_map


def _same(got, want):
    """Equal bit for bit, dtype and shape included."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


def _wav(seed=0, n=4800):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    return (0.3 * np.sin(2 * np.pi * 170 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_exports_are_the_jax_packages():
    assert taudio.__all__ == jaudio.__all__
    assert spectrum.__all__ == jspectrum.__all__
    assert features.__all__ == jfeatures.__all__


@pytest.mark.parametrize("center", [True, False])
def test_stft_istft_and_window(center):
    x = _wav(1)
    for window in ("hann", "hamming", np.hanning(200)):
        _same(spectrum.get_window(window, 200),
              jspectrum.get_window(window, 200))
    kw = dict(n_fft=512, hop_length=120, win_length=400, center=center)
    spec = spectrum.stft(x, **kw)
    _same(spec, jspectrum.stft(x, **kw))
    _same(spectrum.frame_signal(x, 512, 120, center=center),
          jspectrum.frame_signal(x, 512, 120, center=center))
    _same(spectrum.spectrogram(x, power=2.0, **kw),
          jspectrum.spectrogram(x, power=2.0, **kw))
    ikw = dict(hop_length=120, win_length=400, center=center,
               length=len(x))
    _same(spectrum.istft(spec, **ikw), jspectrum.istft(spec, **ikw))


def test_mel_scale_filterbank_and_griffin_lim():
    freqs = np.array([0.0, 200.0, 999.0, 1000.0, 4000.0, 11025.0])
    _same(spectrum.hz_to_mel(freqs), jspectrum.hz_to_mel(freqs))
    mels = spectrum.hz_to_mel(freqs)
    _same(spectrum.mel_to_hz(mels), jspectrum.mel_to_hz(mels))
    for args in ((24000, 2048, 80, 80, 7600), (16000, 512, 40, 0, 8000),
                 (22050, 1024, 80, 0, None)):
        for norm in ("slaney", None):
            _same(spectrum.mel_filterbank(*args, norm=norm),
                  jspectrum.mel_filterbank(*args, norm=norm))
    mag = np.abs(spectrum.stft(_wav(2), n_fft=256, hop_length=64))
    _same(spectrum.griffin_lim(mag, 64, n_iter=3, length=4800),
          jspectrum.griffin_lim(mag, 64, n_iter=3, length=4800))
    logmel = features.LogMelFBank(sr=16000, n_fft=256, hop_length=64,
                                  n_mels=20, fmin=0, fmax=8000)(_wav(3))
    kw = dict(sr=16000, n_fft=256, hop_length=64, fmin=0, fmax=8000,
              n_iter=2)
    _same(spectrum.logmel_to_wav(logmel, **kw),
          jspectrum.logmel_to_wav(logmel, **kw))
    _same(spectrum.inverse_mel(np.exp(logmel.T), 16000, 256, 0, 8000),
          jspectrum.inverse_mel(np.exp(logmel.T), 16000, 256, 0, 8000))


@pytest.mark.parametrize("base", ["10", "e"])
def test_log_mel_fbank(base):
    kw = dict(sr=16000, n_fft=512, hop_length=160, win_length=400,
              n_mels=40, fmin=0, fmax=8000)
    x = _wav(4)
    _same(features.LogMelFBank(**kw).get_log_mel_fbank(x, base=base),
          jfeatures.LogMelFBank(**kw).get_log_mel_fbank(x, base=base))
    _same(features.LogMelFBank()(x), jfeatures.LogMelFBank()(x))
    with pytest.raises(ValueError):
        features.LogMelFBank(**kw).get_log_mel_fbank(x, base="2")


def test_yin_pitch_energy_and_token_averages():
    utt = synthetic.formant_utterance(seed=5)
    wav, dur = utt["wav"], utt["durations"]
    for kw in (dict(use_token_averaged_f0=False),
               dict(use_continuous_f0=False, use_log_f0=False,
                    use_token_averaged_f0=False), dict(duration=dur)):
        _same(features.Pitch(method="yin").get_pitch(wav, **kw),
              jfeatures.Pitch(method="yin").get_pitch(wav, **kw))
    for kw in (dict(use_token_averaged_energy=False), dict(duration=dur)):
        _same(features.Energy().get_energy(wav, **kw),
              jfeatures.Energy().get_energy(wav, **kw))
    values = np.random.default_rng(6).standard_normal(int(dur.sum()))
    values[::7] = 0.0
    _same(features.average_by_duration(values, dur),
          jfeatures.average_by_duration(values, dur))
    mine = features.cached_extractors(24000, 2048, 300, None, 80, 7600, 80,
                                      80, 400)
    theirs = jfeatures.cached_extractors(24000, 2048, 300, None, 80, 7600,
                                         80, 80, 400)
    _same(mine[0](wav), theirs[0](wav))
    _same(mine[1](wav, duration=dur), theirs[1](wav, duration=dur))


def test_world_pitch_where_pyworld_is_installed():
    if importlib.util.find_spec("pyworld") is None:
        pytest.skip("the optional pyworld package is not installed")
    wav = synthetic.formant_utterance(seed=7)["wav"]
    _same(features.Pitch(method="world").get_pitch(wav),
          jfeatures.Pitch(method="world").get_pitch(wav))


def test_normalizers_mu_law_and_quantize():
    x = np.abs(np.random.default_rng(8).standard_normal((5, 7))) + 1e-7
    for name in ("LogMagnitude", "UnitMagnitude"):
        mine, theirs = getattr(taudio, name)(), getattr(jaudio, name)()
        _same(mine.transform(x), theirs.transform(x))
        _same(mine.inverse(mine.transform(x)),
              theirs.inverse(theirs.transform(x)))
    wav = np.clip(_wav(9) * 3, -1.2, 1.2)
    for mu in (255, 15):
        enc = codec.mu_law_encode(wav, mu)
        _same(enc, jcodec.mu_law_encode(wav, mu))
        _same(codec.mu_law_decode(enc, mu), jcodec.mu_law_decode(enc, mu))
    for bands in (256, 65536):
        q = codec.quantize(wav, bands)
        _same(q, jcodec.quantize(wav, bands))
        _same(codec.dequantize(q, bands), jcodec.dequantize(q, bands))


@pytest.mark.parametrize("volume_normalize", [False, True])
def test_wav_round_trip_with_resampling(tmp_path, volume_normalize):
    wav = _wav(10, 24000)
    codec.save_wav(tmp_path / "mine.wav", wav, 24000,
                   volume_normalize=volume_normalize)
    jcodec.save_wav(tmp_path / "theirs.wav", wav, 24000,
                    volume_normalize=volume_normalize)
    assert (tmp_path / "mine.wav").read_bytes() == \
        (tmp_path / "theirs.wav").read_bytes()
    for sr in (None, 24000, 16000, 22050):
        got, got_sr = codec.load_wav(tmp_path / "mine.wav", sr=sr)
        want, want_sr = jcodec.load_wav(tmp_path / "mine.wav", sr=sr)
        assert got_sr == want_sr == (sr or 24000)
        _same(got, want)


def test_soundfile_path_where_soundfile_is_installed(tmp_path):
    if importlib.util.find_spec("soundfile") is None:
        with pytest.raises(ImportError, match="soundfile"):
            codec.load_wav(tmp_path / "x.flac")
        pytest.skip("the optional soundfile package is not installed")
    import soundfile
    soundfile.write(tmp_path / "x.flac", _wav(11), 24000)
    _same(codec.load_wav(tmp_path / "x.flac", sr=16000)[0],
          jcodec.load_wav(tmp_path / "x.flac", sr=16000)[0])


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, sr=16000,
                                                   hop_length=160),
                                dict(phones=[("sil", 0.05), ("i", 0.3),
                                             ("f", 0.1), ("sil", 0.05)],
                                     seed=4)])
def test_formant_utterance(kw):
    mine, theirs = synthetic.formant_utterance(**kw), \
        jsynthetic.formant_utterance(**kw)
    assert mine.keys() == theirs.keys()
    for key in mine:
        if key == "phones":
            assert mine[key] == theirs[key]
        else:
            _same(mine[key], theirs[key])


def test_thread_map_keeps_order():
    items = list(range(37))
    for workers in (1, 4):
        assert thread_map(lambda x: x * x, items, workers) == \
            [x * x for x in items]


@pytest.mark.parametrize("with_tone", [True, False])
@pytest.mark.parametrize("with_erhua", [True, False])
def test_lexicon_is_the_jax_packages(with_tone, with_erhua):
    mine = generate_lexicon(with_tone=with_tone, with_erhua=with_erhua)
    theirs = j_lexicon(with_tone=with_tone, with_erhua=with_erhua)
    assert list(mine.items()) == list(theirs.items())
    for syllable in ("zhi", "lve", "er", "yuan", "wo", "n"):
        assert split_syllable(syllable) == j_split(syllable)


def test_vocab_is_the_jax_packages():
    lexicon = generate_lexicon(with_tone=True, with_erhua=True)
    phones = sorted({p for v in lexicon.values() for p in v.split()})
    for kw in ({}, dict(padding_symbol="<blank>", unk_symbol="<oov>")):
        mine, theirs = Vocab(phones, **kw), JVocab(phones, **kw)
        assert list(mine.stoi.items()) == list(theirs.stoi.items())
        assert len(mine) == len(theirs)
        assert mine(phones[:5] + ["zz9"]) == theirs(phones[:5] + ["zz9"])
        assert [mine.reverse(i) for i in range(len(mine))] == \
            [theirs.reverse(i) for i in range(len(theirs))]
        assert (mine.padding_index, mine.unk_index, mine.start_index,
                mine.end_index, mine.num_specials) == \
            (theirs.padding_index, theirs.unk_index, theirs.start_index,
             theirs.end_index, theirs.num_specials)
