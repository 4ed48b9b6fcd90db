"""The port's text-to-wav CLIs against the JAX package's, on the CPU: the
FastSpeech2, SpeedySpeech and TransformerTTS ``synthesize_e2e.py`` twins
and the twin of ``tools/serve.py``, each run through ``main(argv)`` with
``--device cpu`` on JAX-written snapshots at tiny widths, the JAX CLI
run in this process (``sys.argv`` patched).

Held: the phone ids of every line identical; the acoustic model's mels
within 1e-5 of their range (float32); each Griffin-Lim wav bit for bit
the JAX package's ``logmel_to_wav`` of the port's mel with the JAX CLI's
arguments (the two CLIs' wavs are not held to 1e-5 of each other: 32
Griffin-Lim iterations on 10^mel turn the mels' float32 differences into
about 3e-5 of the wav's range); the Parallel WaveGAN wavs on the same
noise (the port's, handed to the JAX CLI; the two packages' random
streams differ) within 1e-5 of their range through the 'xla' stack and
within 2^-8 through the recipe's 'pallas' stack (K1's plain version
against the Pallas kernel in interpret mode, as
tests/test_torch_slice.py holds them). The random weights make every
token two frames long, away from a rounding edge, and TransformerTTS
decodes every step (its stop logit far below the threshold) with no
dropout. ``--sp 2`` is refused, and each CLI without ``--device cpu``
raises on a machine without a card.
"""
import importlib.util
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import parakeet_tpu.audio.codec as jcodec
import parakeet_tpu.audio.spectrum as jspectrum
import parakeet_tpu.frontend.cli as jcli
from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import PWGGenerator as JPWG
from parakeet_tpu.models import SpeedySpeech as JSS
from parakeet_tpu.models import TransformerTTS as JTTS
from parakeet_tpu.training.checkpoint import (flatten_tree, nest_flat,
                                              save_pytree)
from parakeet_tpu_torch.models import ConditionalWaveFlow
from parakeet_tpu_torch.bridge import flax_arrays
from parakeet_tpu_torch.recipes.fastspeech2 import serve
from parakeet_tpu_torch.recipes.fastspeech2 import \
    synthesize_e2e as fs2_e2e
from parakeet_tpu_torch.recipes.speedyspeech import \
    synthesize_e2e as ss_e2e
from parakeet_tpu_torch.recipes.synthesis import write_id_maps
from parakeet_tpu_torch.recipes.transformer_tts import \
    synthesize_e2e as tts_e2e
from parakeet_tpu_torch.serving import TTSEngine
from test_torch_ge2e import _jax_recipe
from test_torch_speedyspeech import _close, _randomize

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AUDIO = dict(fs=8000, n_fft=256, n_shift=64, win_length=256, fmin=0,
             fmax=4000, n_mels=10)
FS2_MODEL = dict(adim=16, aheads=2, elayers=1, eunits=32, dlayers=1,
                 dunits=32, postnet_layers=2, postnet_chans=8,
                 postnet_filts=5, duration_predictor_chans=16,
                 pitch_predictor_chans=16, energy_predictor_chans=16,
                 positionwise_layer_type="conv1d",
                 positionwise_conv_kernel_size=3)
PWG_PARAMS = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
                  skip_channels=32, aux_channels=10, aux_context_window=1,
                  upsample_scales=[2, 2])
SS_MODEL = dict(encoder_hidden_size=16, encoder_kernel_size=3,
                encoder_dilations=[1, 3], duration_predictor_hidden_size=16,
                decoder_hidden_size=16, decoder_output_size=10,
                decoder_kernel_size=3, decoder_dilations=[1, 3])
TTS_MODEL = dict(embed_dim=8, eprenet_conv_layers=0, dprenet_layers=2,
                 dprenet_units=8, elayers=1, eunits=16, adim=16, aheads=2,
                 dlayers=1, dunits=16, postnet_layers=2, postnet_chans=8,
                 postnet_filts=3, **dict.fromkeys((
                     "transformer_enc_dropout_rate",
                     "transformer_enc_positional_dropout_rate",
                     "transformer_enc_attn_dropout_rate",
                     "transformer_dec_dropout_rate",
                     "transformer_dec_positional_dropout_rate",
                     "transformer_dec_attn_dropout_rate",
                     "transformer_enc_dec_attn_dropout_rate",
                     "eprenet_dropout_rate", "dprenet_dropout_rate",
                     "postnet_dropout_rate"), 0.0))
ZH_TEXT = ("zh1 今天天气很好，我们一起去公园散步吧。\n"
           "\n"
           "zh2 2024年3月15日下午3点，气温是25°C。\n"
           "zh3 长得很高的孩子们都在操场上玩。\n")
EN_TEXT = ("en1 Hello world, this is a test.\n"
           "en2 Dr. Smith paid $3.50 for 2 apples on Jan. 5th!\n")
MAX_TEXT, MAX_FRAMES, STEPS = 48, 128, 12
# the recipe's 'pallas' stack: Pallas in interpret mode against K1's plain
# version, both rounding operands to bf16 (tests/test_torch_slice.py)
PALLAS_WAV_REL_TOL = 2 ** -8
GRIFFIN_LIM = jspectrum.logmel_to_wav
GL_ARGS = (AUDIO["fs"], AUDIO["n_fft"], AUDIO["n_shift"],
           AUDIO["win_length"])
GL_KW = dict(fmin=AUDIO["fmin"], fmax=AUDIO["fmax"])


def _yaml(path, **sections):
    path.write_text(yaml.safe_dump(sections))
    return path


def _flat(module, seed, *args, **kw):
    """A numpy-randomized flat flax tree of ``module.init(*args, **kw)``."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, **kw), jax.random.PRNGKey(seed))
    return _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), seed)


def _durations_of_two(flat, head, log_d):
    """Every token 2 frames, away from a rounding edge: the duration head
    ``head``'s kernel zero and its bias ``log_d``."""
    flat[head + "::kernel"] = np.zeros_like(flat[head + "::kernel"])
    flat[head + "::bias"] = np.full_like(flat[head + "::bias"], log_d)
    return flat


def _count(path):
    with open(path) as f:
        return sum(1 for _ in f)


def _pwg_snapshot(tmp_path, stack_impl):
    conf = _yaml(tmp_path / f"pwg_{stack_impl}.yaml", **AUDIO,
                 generator_params={**PWG_PARAMS, "stack_impl": stack_impl})
    flat = _flat(JPWG(**{**PWG_PARAMS, "stack_impl": "xla"}), 1,
                 jnp.zeros((1, 16, 1)), jnp.zeros((1, 6, 10)))
    ckpt = tmp_path / "pwg.npz"
    save_pytree(ckpt, nest_flat(flat))
    return conf, ckpt


@pytest.fixture(scope="module")
def zh(tmp_path_factory):
    """A FastSpeech2 snapshot over the Chinese frontend's phone map (and 3
    speakers), the PWG YAMLs, mel statistics and the sentences."""
    d = tmp_path_factory.mktemp("zh")
    maps = write_id_maps(d, "zh")
    idim = _count(maps["phones"])
    (d / "spk.txt").write_text("a 0\nb 1\nc 2\n")
    conf = _yaml(d / "fs2.yaml", **AUDIO,
                 model={**FS2_MODEL, "init_type": "xavier_uniform"})
    paths = {"dir": d, "conf": conf, "maps": maps}
    for spk in (False, True):
        # the CLIs' default speaker width, 256, with --speaker-dict
        kw = dict(num_speakers=3, spk_embed_dim=256) if spk else {}
        jm = JFS2(idim=idim, odim=10, **FS2_MODEL, **kw)
        flat = _flat(jm, 3, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
                     max_frames=32, spk_id=jnp.asarray([0]) if spk else None,
                     method=JFS2.inference)
        head = "params::duration_predictor::stack::linear"
        flat = _durations_of_two(flat, head, np.log(3.0))  # exp - 1
        paths["fs2_spk" if spk else "fs2"] = d / f"fs2_{int(spk)}.npz"
        save_pytree(paths["fs2_spk" if spk else "fs2"], nest_flat(flat))
    for impl in ("xla", "pallas"):
        paths[f"pwg_{impl}"] = _pwg_snapshot(d, impl)
    rng = np.random.default_rng(4)
    for name in ("am_stat", "voc_stat"):
        paths[name] = d / f"{name}.npy"
        np.save(paths[name], np.stack([
            rng.standard_normal(10), 0.5 + rng.random(10)]).astype(
                np.float32))
    (d / "zh.txt").write_text(ZH_TEXT)
    # the JAX SpeedySpeech CLI takes no blank line
    (d / "zh_ss.txt").write_text(ZH_TEXT.replace("\n\n", "\n"))
    return paths


class _JaxCalls:
    """Records of a JAX CLI's run: its ids, the vocoders' mels, the
    Griffin-Lim mels and wavs, the wavs it saves (before the 16-bit
    file)."""

    def __init__(self):
        self.ids, self.voc_mels, self.gl, self.saved = [], [], [], {}

    def ids_of(self, build):
        def wrapped(*a, **kw):
            fn = build(*a, **kw)

            def get_ids(sentence):
                out = fn(sentence)
                self.ids.append(list(out))
                return out
            return get_ids
        return wrapped

    def griffin_lim(self, real):
        def wrapped(mel, *a, **kw):
            wav = real(mel, *a, **kw)
            self.gl.append((np.asarray(mel), np.asarray(wav)))
            return wav
        return wrapped

    def save(self, path, wav, sr, *a, **kw):
        self.saved[Path(path).stem] = np.asarray(wav).reshape(-1)


def _port_noise(seed, n):
    """The port's vocoder noise on the CPU: (1, n, 1) from a generator
    seeded ``seed``."""
    return torch.randn((1, n, 1), generator=torch.Generator().manual_seed(
        seed)).numpy()


def _pwg_with_port_noise(calls, real, seeds):
    """The JAX CLI's ``pwg_inference`` (or streaming) on the port's noise
    for the next line's seed."""
    def wrapped(gen, variables, mel, rng=None, **kw):
        calls.voc_mels.append(np.asarray(mel))
        n = mel.shape[-2] * gen.upsample_factor
        noise = _port_noise(seeds[len(calls.voc_mels) - 1], n)
        return real(gen, variables, mel, noise=jnp.asarray(noise), **kw)
    return wrapped


def _run_jax(monkeypatch, name, argv, calls, module=None):
    mod = module or _jax_recipe(name)
    monkeypatch.setattr(jspectrum, "logmel_to_wav",
                        calls.griffin_lim(jspectrum.logmel_to_wav))
    if hasattr(mod, "save_wav"):
        monkeypatch.setattr(mod, "save_wav", calls.save)
    monkeypatch.setattr(jcodec, "save_wav", calls.save)
    if hasattr(mod, "build_text_to_ids"):
        monkeypatch.setattr(mod, "build_text_to_ids",
                            calls.ids_of(mod.build_text_to_ids))
    monkeypatch.setattr(jcli, "build_text_to_ids",
                        calls.ids_of(jcli.build_text_to_ids))
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    mod.main()
    return mod


def _fs2_argv(zh, out, *, spk=False, stats=False, pwg=None):
    argv = ["--fastspeech2-config", zh["conf"], "--fastspeech2-checkpoint",
            zh["fs2_spk" if spk else "fs2"], "--phones-dict",
            zh["maps"]["phones"], "--text", zh["dir"] / "zh.txt",
            "--output-dir", out, "--max-text-len", MAX_TEXT,
            "--max-frames", MAX_FRAMES, "--device", "cpu"]
    if spk:
        argv += ["--speaker-dict", zh["dir"] / "spk.txt", "--spk-id", "2"]
    if stats:
        argv += ["--fastspeech2-stat", zh["am_stat"]]
    if pwg is not None:
        conf, ckpt = zh[f"pwg_{pwg}"]
        argv += ["--pwg-config", conf, "--pwg-checkpoint", ckpt]
        if stats:
            argv += ["--pwg-stat", zh["voc_stat"]]
    return argv


def test_fastspeech2_cli_griffin_lim_matches_jax(zh, tmp_path, monkeypatch):
    """No vocoder, a speaker of three, the AM's statistics: ids identical,
    the mels given to Griffin-Lim within 1e-5 of their range, each wav
    the JAX ``logmel_to_wav`` of the port's mel bit for bit; the blank
    line skipped."""
    argv = _fs2_argv(zh, tmp_path / "port", spk=True, stats=True)
    got = fs2_e2e.main([str(a) for a in argv])
    calls = _JaxCalls()
    _run_jax(monkeypatch, "fastspeech2/synthesize_e2e.py",
             _fs2_argv(zh, tmp_path / "jax", spk=True, stats=True), calls)
    lines = got["lines"]
    assert [r["utt_id"] for r in lines] == ["zh1", "zh2", "zh3"]
    assert [r["ids"] for r in lines] == calls.ids
    for r, (mel, wav) in zip(lines, calls.gl):
        assert r["frames"] == 2 * len(r["ids"]) == mel.shape[0]
        _close(r["mel"], mel, what=f"{r['utt_id']} mel")
        assert r["wav"].shape == wav.shape and r["vocoder_s"] is None
        assert np.array_equal(r["wav"], GRIFFIN_LIM(r["mel"], *GL_ARGS,
                                                     **GL_KW))
        assert Path(r["path"]).is_file()


@pytest.mark.parametrize("impl,rel", [("xla", 1e-5),
                                      ("pallas", PALLAS_WAV_REL_TOL)])
def test_fastspeech2_cli_pwg_matches_jax(zh, tmp_path, monkeypatch, impl,
                                         rel):
    """Parallel WaveGAN with both statistics files: the vocoder's input
    mels within 1e-5 of their range, the wavs on the port's noise (seeded
    with the utt_id's CRC-32) within ``rel`` of their range."""
    got = fs2_e2e.main([str(a) for a in _fs2_argv(
        zh, tmp_path / "port", stats=True, pwg=impl)])
    calls = _JaxCalls()
    mod = _jax_recipe("fastspeech2/synthesize_e2e.py")
    seeds = [zlib.crc32(u.encode()) for u in ("zh1", "zh2", "zh3")]
    monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
        calls, mod.pwg_inference, seeds))
    _run_jax(monkeypatch, "fastspeech2/synthesize_e2e.py", _fs2_argv(
        zh, tmp_path / "jax", stats=True, pwg=impl), calls, mod)
    mu, sigma = np.load(zh["voc_stat"])
    hop = int(np.prod(PWG_PARAMS["upsample_scales"]))
    assert [r["ids"] for r in got["lines"]] == calls.ids
    for r, mel in zip(got["lines"], calls.voc_mels):
        _close((r["mel"] - mu) / sigma, mel, what=f"{r['utt_id']} mel")
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == r["frames"] * hop == len(want)
        _close(r["wav"], want, rel=rel, what=f"{r['utt_id']} wav")


def test_fastspeech2_cli_streaming_is_one_shot(zh, tmp_path):
    """``--streaming-chunk-frames`` (windows far shorter than the lines)
    gives the one-shot wavs: the JAX package's promise, and the port's
    ``pwg_streaming_inference`` holds it exactly on the CPU."""
    argv = [str(a) for a in _fs2_argv(zh, tmp_path / "a", pwg="xla")]
    once = fs2_e2e.main(argv)
    argv[argv.index("--output-dir") + 1] = str(tmp_path / "b")
    chunked = fs2_e2e.main(argv + ["--streaming-chunk-frames", "8"])
    for a, b in zip(once["lines"], chunked["lines"]):
        assert a["frames"] > 8 + 2 * 13
        _close(b["wav"], a["wav"], what=a["utt_id"])


@pytest.fixture(scope="module")
def ss(tmp_path_factory, zh):
    """A SpeedySpeech snapshot over the tone-split phone map."""
    d = tmp_path_factory.mktemp("ss")
    maps = zh["maps"]
    conf = _yaml(d / "ss.yaml", **AUDIO, model=SS_MODEL)
    jm = JSS(vocab_size=_count(maps["tone_phones"]),
             tone_size=_count(maps["tones"]), **SS_MODEL)
    ids = jnp.ones((1, 8), jnp.int64)
    flat = _flat(jm, 5, ids, jnp.full((1, 8), 2), tones=ids, max_frames=16)
    head = "params::duration_predictor::fc"
    flat = _durations_of_two(flat, head, np.log(2.0))
    ckpt = d / "ss.npz"
    save_pytree(ckpt, nest_flat(flat))
    return {"conf": conf, "ckpt": ckpt, "model": jm, "vars": nest_flat(flat)}


def test_speedyspeech_cli_matches_jax(zh, ss, tmp_path, monkeypatch):
    """The tones path with the mel statistics: ids and tones identical to
    the JAX frontend's, the mels within 1e-5 of their range of the JAX
    model's on the same padded ids, the wavs (the whole ``--max-frames``
    mel vocoded on the same noise, cut to the frames) within 1e-5."""
    conf, ckpt = zh["pwg_xla"]
    argv = ["--config", ss["conf"], "--checkpoint", ss["ckpt"], "--stat",
            zh["am_stat"], "--pwg-config", conf, "--pwg-checkpoint", ckpt,
            "--phones-dict", zh["maps"]["tone_phones"], "--tones-dict",
            zh["maps"]["tones"], "--text", zh["dir"] / "zh_ss.txt",
            "--max-text-len", MAX_TEXT, "--max-frames", MAX_FRAMES,
            "--device", "cpu"]
    got = ss_e2e.main([str(a) for a in argv + ["--output-dir",
                                                tmp_path / "port"]])
    hop = int(np.prod(PWG_PARAMS["upsample_scales"]))
    noise = _port_noise(0, MAX_FRAMES * hop)
    real_normal = jax.random.normal

    def port_normal(key, shape, *a, **kw):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise)
        return real_normal(key, shape, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", port_normal)
    calls = _JaxCalls()
    mod = _jax_recipe("speedyspeech/synthesize_e2e.py")
    frontend = mod.Frontend(phone_vocab_path=zh["maps"]["tone_phones"],
                            tone_vocab_path=zh["maps"]["tones"])
    _run_jax(monkeypatch, "speedyspeech/synthesize_e2e.py",
             argv + ["--output-dir", tmp_path / "jax"], calls, mod)
    mu, sigma = np.load(zh["am_stat"])
    assert [r["utt_id"] for r in got["lines"]] == ["zh1", "zh2", "zh3"]
    for r in got["lines"]:
        sentence = dict(line.split(maxsplit=1) for line in
                        ZH_TEXT.splitlines() if line)[r["utt_id"]]
        want_ids = frontend.get_input_ids(sentence)
        assert r["ids"] == want_ids["phone_ids"][0]
        assert r["tones"] == want_ids["tone_ids"][0]
        text = np.zeros((1, MAX_TEXT), np.int64)
        tones = np.zeros((1, MAX_TEXT), np.int64)
        text[0, :len(r["ids"])] = r["ids"]
        tones[0, :len(r["ids"])] = r["tones"]
        out = ss["model"].apply(ss["vars"], jnp.asarray(text),
                                jnp.asarray(tones), max_frames=MAX_FRAMES,
                                method=JSS.inference)
        # SpeedySpeech expands the padding too: 2 frames a slot
        assert r["frames"] == int(out["frame_lengths"][0]) == 2 * MAX_TEXT
        _close(r["mel"], np.asarray(out["mel"])[0, :r["frames"]] * sigma
               + mu, what=f"{r['utt_id']} mel")
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == len(want) == r["frames"] * hop
        _close(r["wav"], want, what=f"{r['utt_id']} wav")


@pytest.fixture(scope="module")
def en(tmp_path_factory, zh):
    """A TransformerTTS snapshot over the ARPABET phone map, with its stop
    logit far below the threshold; a tiny WaveFlow checkpoint."""
    d = tmp_path_factory.mktemp("en")
    maps = write_id_maps(d, "en")
    conf = _yaml(d / "tts.yaml", **AUDIO, model={
        **TTS_MODEL, "init_type": "xavier_uniform", "reduction_factor": 1})
    jm = JTTS(idim=_count(maps["phones"]), odim=10, **TTS_MODEL)
    flat = _flat(jm, 7, jnp.ones((1, 6), jnp.int32), jnp.asarray([6]),
                 jnp.zeros((1, 4, 10)), jnp.asarray([4]),
                 deterministic=False)
    flat["params::prob_out::bias"][:] = -10.0
    ckpt = d / "tts.npz"
    save_pytree(ckpt, nest_flat(flat))
    (d / "en.txt").write_text(EN_TEXT)
    wf = dict(upsample_factors=[2, 2], n_flows=2, n_layers=2, n_group=4,
              channels=8, n_mels=10)
    wf_conf = _yaml(d / "wf.yaml", **AUDIO, model=wf)
    wf_ckpt = d / "wf.npz"
    from parakeet_tpu_torch.training import save_pytree as t_save
    t_save(wf_ckpt, flax_arrays(ConditionalWaveFlow(**wf)))
    return {"conf": conf, "ckpt": ckpt, "maps": maps, "dir": d,
            "wf": (wf_conf, wf_ckpt)}


def _tts_argv(en, out, *voc):
    return ["--config", en["conf"], "--checkpoint", en["ckpt"],
            "--phones-dict", en["maps"]["phones"], "--text",
            en["dir"] / "en.txt", "--output-dir", out, "--max-text-len",
            MAX_TEXT, "--max-decoder-steps", STEPS, "--device", "cpu",
            *voc]


def test_transformer_tts_cli_matches_jax(zh, en, tmp_path, monkeypatch):
    """English text through the decode loop: ids identical, the mels
    (written as .npy without a vocoder) within 1e-5 of their range, every
    step decoded; with PWG the wavs on the same noise (seed 0 for every
    line) within 1e-5; with WaveFlow finite wavs of frames x 4 samples."""
    got = tts_e2e.main([str(a) for a in _tts_argv(en, tmp_path / "port")])
    calls = _JaxCalls()
    _run_jax(monkeypatch, "transformer_tts/synthesize_e2e.py",
             _tts_argv(en, tmp_path / "jax"), calls)
    # the frontend's ids, cut to --max-text-len by both CLIs
    assert [r["ids"] for r in got["lines"]] == [i[:MAX_TEXT]
                                                 for i in calls.ids]
    assert len(calls.ids) == 2 and len(calls.ids[1]) > MAX_TEXT
    for r in got["lines"]:
        want = np.load(tmp_path / "jax" / f"{r['utt_id']}.npy")
        assert r["frames"] == STEPS == want.shape[0]
        _close(np.load(r["path"]), want, what=r["utt_id"])
    conf, ckpt = zh["pwg_xla"]
    voc = ["--pwg-config", conf, "--pwg-checkpoint", ckpt]
    got = tts_e2e.main([str(a) for a in _tts_argv(en, tmp_path / "p2",
                                                  *voc)])
    calls = _JaxCalls()
    mod = _jax_recipe("transformer_tts/synthesize_e2e.py")
    monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
        calls, mod.pwg_inference, [0, 0]))
    _run_jax(monkeypatch, "transformer_tts/synthesize_e2e.py",
             _tts_argv(en, tmp_path / "j2", *voc), calls, mod)
    for r, mel in zip(got["lines"], calls.voc_mels):
        _close(r["mel"], mel, what=f"{r['utt_id']} mel")
        _close(r["wav"], calls.saved[r["utt_id"]], what=r["utt_id"])
    wf_conf, wf_ckpt = en["wf"]
    got = tts_e2e.main([str(a) for a in _tts_argv(
        en, tmp_path / "wf", "--waveflow-config", wf_conf,
        "--waveflow-checkpoint", wf_ckpt)])
    assert got["sample_rate"] == AUDIO["fs"]
    for r in got["lines"]:
        assert r["samples"] == r["frames"] * 4
        assert np.isfinite(r["wav"]).all() and r["vocoder_s"] > 0


def _serve_argv(zh, out, *extra):
    return ["--fastspeech2-config", zh["conf"], "--fastspeech2-checkpoint",
            zh["fs2"], "--phones-dict", zh["maps"]["phones"], "--text",
            zh["dir"] / "zh.txt", "--output-dir", out, "--text-buckets",
            "16", "32", "--batch-size", "2", "--frames-per-token", "4",
            "--device", "cpu", *extra]


def _load_serve():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_serve", ROOT / "tools" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("overflow", ["split", "truncate"])
def test_serve_cli_matches_jax(zh, tmp_path, monkeypatch, overflow):
    """The serving twin on the same sentences, longer than the largest
    text bucket (32) but one: ids identical, the engine's Griffin-Lim mels
    within 1e-5 of their range, each wav the JAX ``logmel_to_wav`` of the
    port's mel bit for bit; with PWG (the recipe's 'pallas'
    stack, ``--warmup``) each request's wav on the JAX engine's noise rows
    within 2^-8 of its range; ``--overflow error`` raises."""
    port_calls = _JaxCalls()
    monkeypatch.setattr(serve, "save_wav", port_calls.save)
    monkeypatch.setattr(serve, "logmel_to_wav",
                        port_calls.griffin_lim(serve.logmel_to_wav))
    got = serve.main([str(a) for a in _serve_argv(
        zh, tmp_path / "port", "--overflow", overflow)])
    calls = _JaxCalls()
    _run_jax(monkeypatch, "serve.py", _serve_argv(
        zh, tmp_path / "jax", "--overflow", overflow), calls, _load_serve())
    assert [list(r.ids) for r in got["requests"]] == calls.ids
    assert any(len(ids) > 32 for ids in calls.ids)
    for (mel, wav), (jmel, _) in zip(port_calls.gl, calls.gl):
        _close(mel, jmel, what="mel")
        assert np.array_equal(wav, GRIFFIN_LIM(mel, *GL_ARGS, **GL_KW))
    assert sorted(port_calls.saved) == sorted(calls.saved)
    conf, ckpt = zh["pwg_pallas"]
    voc = ["--pwg-config", conf, "--pwg-checkpoint", ckpt, "--warmup",
           "--overflow", overflow]

    def jax_noise_row(self, seed, tb):
        n = self.max_frames(tb) * self.hop
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (n, 1))))

    monkeypatch.setattr(TTSEngine, "_noise_row", jax_noise_row)
    got = serve.main([str(a) for a in _serve_argv(zh, tmp_path / "p2",
                                                  *voc)])
    assert got["engine"].compiled_programs == 2 * 2
    calls = _JaxCalls()
    _run_jax(monkeypatch, "serve.py", _serve_argv(zh, tmp_path / "j2",
                                                  *voc), calls,
             _load_serve())
    for res in got["results"]:
        want = calls.saved[res.utt_id]
        assert res.wav.shape == want.shape and res.n_frames > 0
        _close(res.wav, want, rel=PALLAS_WAV_REL_TOL, what=res.utt_id)
    with pytest.raises(ValueError, match="overflow='error'"):
        serve.main([str(a) for a in _serve_argv(
            zh, tmp_path / "p3", "--overflow", "error")])


def test_unported_flags_are_refused(zh, ss, tmp_path):
    """``--sp 2`` (ROADMAP item 18) raises SystemExit naming its item, and
    ``--export-dir`` without a vocoder raises as the JAX CLI does; nothing
    runs.  (``--export-dir`` with one is ported:
    tests/test_torch_synthesize.py.)"""
    argv = [str(a) for a in _fs2_argv(zh, tmp_path / "out")]
    with pytest.raises(SystemExit, match="item 18"):
        fs2_e2e.main(argv + ["--sp", "2"])
    with pytest.raises(SystemExit, match="requires --pwg-checkpoint"):
        fs2_e2e.main(argv + ["--export-dir", str(tmp_path / "exp")])
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "exp").exists()
    # the SpeedySpeech twin takes no --sp, as its JAX CLI
    conf, ckpt = zh["pwg_xla"]
    with pytest.raises(SystemExit):
        ss_e2e.main([str(a) for a in [
            "--config", ss["conf"], "--checkpoint", ss["ckpt"],
            "--pwg-config", conf, "--pwg-checkpoint", ckpt, "--phones-dict",
            zh["maps"]["tone_phones"], "--text", zh["dir"] / "zh.txt",
            "--sp", "2", "--device", "cpu"]])


def test_clis_without_device_cpu_raise_without_a_card(zh, ss, en,
                                                       tmp_path):
    """The default device is the card: without one, each CLI raises before
    it synthesizes anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal of a machine without a card")
    def strip(argv):
        argv = [str(a) for a in argv]
        i = argv.index("--device")
        return argv[:i] + argv[i + 2:]

    conf, ckpt = zh["pwg_xla"]
    runs = [
        (fs2_e2e.main, _fs2_argv(zh, tmp_path / "a")),
        (ss_e2e.main, ["--config", ss["conf"], "--checkpoint", ss["ckpt"],
                       "--pwg-config", conf, "--pwg-checkpoint", ckpt,
                       "--phones-dict", zh["maps"]["tone_phones"],
                       "--text", zh["dir"] / "zh.txt", "--output-dir",
                       tmp_path / "b", "--device", "cpu"]),
        (tts_e2e.main, _tts_argv(en, tmp_path / "c")),
        (serve.main, _serve_argv(zh, tmp_path / "d"))]
    for main, argv in runs:
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(strip(argv))
    assert not any((tmp_path / n).exists() for n in "abcd")
