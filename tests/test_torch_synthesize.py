"""The port's synthesis from a dump, its exported programs and its deploy
CLIs against the JAX package's, on the CPU: the ``synthesize.py`` twins
of Parallel WaveGAN, FastSpeech2, Tacotron2, WaveFlow and TransformerTTS,
``pwgan/synthesize_from_wav.py``, ``--export-dir`` of the FastSpeech2 and
SpeedySpeech ``synthesize_e2e.py`` twins (``torch.export``) against
``jax.export``'s programs, and the two ``inference.py`` twins against the
port's own ``synthesize_e2e.py``; K1's registered operator on meta
tensors.

Each CLI runs through ``main(argv)`` with ``--device cpu`` on JAX-written
snapshots at tiny widths (the JAX CLI in this process, ``sys.argv``
patched), over a metadata file of three rows (one longer than the text
buffer, one mel longer than the vocoder's capacity).  The two packages'
random streams differ, so each JAX vocoder is handed the port's noise.
Held: the acoustic models' mels within 1e-5 of their range (float32);
the Parallel WaveGAN wavs within 1e-5 through the 'xla' stack and 2^-8
through the recipe's 'pallas' stack (K1's plain version against the
Pallas kernel in interpret mode, as tests/test_torch_synthesize_e2e.py
holds them); the decodes' stop frames equal (a stop logit far below the
threshold, which decodes every step, and far above it, which stops
early); WaveFlow's wavs within 1e-4 of their range (eight inverted
flows amplify float32 rounding through exp(-logs), as
tests/test_torch_waveflow.py holds the sampler).  An export made on the
CPU holds K1's plain version, no operator; ``inference.py`` runs it bit
for bit as the eager programs, and refuses a program made for another
device and a directory of ``.jaxexport`` files only.
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

import parakeet_tpu.audio.features as jfeatures
from parakeet_tpu.audio.codec import save_wav as jsave_wav
from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import Tacotron2 as JT2
from parakeet_tpu.models import TransformerTTS as JTTS
from parakeet_tpu.models import waveflow as jwf
from parakeet_tpu.training.checkpoint import nest_flat, save_pytree
from parakeet_tpu_torch.models import pwg_inference
from parakeet_tpu_torch.ops.kernels import pwg_stack
from parakeet_tpu_torch.ops.normalizer import ZScore
from parakeet_tpu_torch.recipes import synthesis
from parakeet_tpu_torch.recipes.fastspeech2 import inference as fs2_inf
from parakeet_tpu_torch.recipes.fastspeech2 import synthesize as fs2_syn
from parakeet_tpu_torch.recipes.fastspeech2 import \
    synthesize_e2e as fs2_e2e
from parakeet_tpu_torch.recipes.pwgan import synthesize as pwg_syn
from parakeet_tpu_torch.recipes.pwgan import synthesize_from_wav as copy_syn
from parakeet_tpu_torch.recipes.speedyspeech import inference as ss_inf
from parakeet_tpu_torch.recipes.speedyspeech import \
    synthesize_e2e as ss_e2e
from parakeet_tpu_torch.recipes.tacotron2 import synthesize as t2_syn
from parakeet_tpu_torch.recipes.transformer_tts import \
    synthesize as tts_syn
from parakeet_tpu_torch.recipes.waveflow import synthesize as wf_syn
from test_torch_ge2e import _jax_recipe
from test_torch_speedyspeech import _close
from test_torch_synthesize_e2e import (AUDIO, FS2_MODEL, MAX_FRAMES,
                                       MAX_TEXT, PALLAS_WAV_REL_TOL,
                                       PWG_PARAMS, STEPS, TTS_MODEL,
                                       _durations_of_two, _flat, _JaxCalls,
                                       _port_noise, _pwg_snapshot,
                                       _pwg_with_port_noise, _run_jax,
                                       _yaml)
from test_torch_synthesize_e2e import ss, zh  # noqa: F401  fixtures

torch.set_num_threads(1)

HOP = int(np.prod(PWG_PARAMS["upsample_scales"]))
N_PHONES = 12
# rows: (utt_id, token count, mel frames, speaker); the second is longer
# than the text buffer, the third's mel longer than the vocoder's capacity
ROWS = [("u1", 5, 20, 0), ("u2", MAX_TEXT + 12, 40, 2), ("u3", 9, 200, 1)]
T2_MODEL = dict(d_encoder=16, encoder_conv_layers=1, d_prenet=8,
                d_attention_rnn=12, d_decoder_rnn=12, d_attention=8,
                attention_filters=4, d_postnet=8, postnet_conv_layers=2,
                **dict.fromkeys(("p_encoder_dropout", "p_prenet_dropout",
                                 "p_attention_dropout", "p_decoder_dropout",
                                 "p_postnet_dropout"), 0.0))
WF_MODEL = dict(upsample_factors=[2, 2], n_flows=2, n_layers=2, n_group=4,
                channels=8, n_mels=10)
WF_REL_TOL = 1e-4


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A normalized dump of ROWS (numpy seed 11): token ids, speakers and
    mel features, the phone and speaker maps, mel statistics, the PWG
    snapshots ('xla' and 'pallas')."""
    d = tmp_path_factory.mktemp("dump")
    rng = np.random.default_rng(11)
    (d / "phones.txt").write_text("".join(f"p{i} {i}\n"
                                          for i in range(N_PHONES)))
    (d / "spk.txt").write_text("a 0\nb 1\nc 2\n")
    rows = []
    for utt, n_ids, frames, spk in ROWS:
        feats = d / f"{utt}_feats.npy"
        np.save(feats, rng.standard_normal((frames, 10)).astype(np.float32))
        rows.append({"utt_id": utt, "text": [int(v) for v in rng.integers(
            1, N_PHONES, n_ids)], "spk_id": spk, "feats": str(feats)})
    (d / "metadata.jsonl").write_text("".join(json.dumps(r) + "\n"
                                              for r in rows))
    stat = d / "stat.npy"
    np.save(stat, np.stack([rng.standard_normal(10),
                            0.5 + rng.random(10)]).astype(np.float32))
    out = {"dir": d, "md": d / "metadata.jsonl", "phones": d / "phones.txt",
           "spk": d / "spk.txt", "stat": stat}
    for impl in ("xla", "pallas"):
        out[f"pwg_{impl}"] = _pwg_snapshot(d, impl)
    return out


def _argv(*args):
    return [str(a) for a in args]


def _jax_saved(monkeypatch, name, argv, module=None, calls=None):
    """Run the JAX CLI ``recipes/<name>`` with ``argv`` (``--device cpu``
    added); returns its calls (the wavs it saves, the vocoders' mels)."""
    calls = calls or _JaxCalls()
    _run_jax(monkeypatch, name, list(argv) + ["--device", "cpu"], calls,
             module)
    return calls


@pytest.mark.parametrize("impl,rel", [("xla", 1e-5),
                                      ("pallas", PALLAS_WAV_REL_TOL)])
def test_pwgan_synthesize_matches_jax(dump, tmp_path, monkeypatch, impl,
                                      rel):
    """Each row's mel cut or padded to ``--max-frames`` and vocoded on the
    same noise (the port's, seeded 0 for every row): the wavs within
    ``rel`` of their range, cut to the row's frames."""
    conf, ckpt = dump[f"pwg_{impl}"]
    argv = ["--config", conf, "--checkpoint", ckpt, "--test-metadata",
            dump["md"], "--max-frames", MAX_FRAMES]
    got = pwg_syn.main(_argv(*argv, "--output-dir", tmp_path / "port",
                             "--device", "cpu"))
    mod = _jax_recipe("pwgan/synthesize.py")
    calls = _JaxCalls()
    monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
        calls, mod.pwg_inference, [0] * len(ROWS)))
    _jax_saved(monkeypatch, "pwgan/synthesize.py",
               argv + ["--output-dir", tmp_path / "jax"], mod, calls)
    assert [r["frames"] for r in got["lines"]] == [20, 40, MAX_FRAMES]
    for r in got["lines"]:
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == r["frames"] * HOP == len(want)
        _close(r["wav"], want, rel=rel, what=r["utt_id"])
        assert Path(r["path"]).is_file()


def test_synthesize_from_wav_matches_jax(dump, tmp_path, monkeypatch):
    """Two wavs (one longer than ``--max-frames`` allows): the log-mel
    z-scored with the statistics bit for bit the JAX extractor's, the
    copy-synthesized wavs on the same noise within 1e-5 of their range,
    written as ``<stem>_gen.wav``."""
    rng = np.random.default_rng(12)
    wavs = []
    for i, seconds in enumerate((0.5, 2.0)):
        t = np.arange(int(AUDIO["fs"] * seconds)) / AUDIO["fs"]
        wav = (0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t)
               + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        wavs.append(tmp_path / f"in{i}.wav")
        jsave_wav(wavs[-1], wav, AUDIO["fs"])
    conf, ckpt = dump["pwg_xla"]
    argv = ["--config", conf, "--checkpoint", ckpt, "--stats", dump["stat"],
            "--input-wav", *wavs, "--max-frames", MAX_FRAMES]
    got = copy_syn.main(_argv(*argv, "--output-dir", tmp_path / "port",
                              "--device", "cpu"))
    mod = _jax_recipe("pwgan/synthesize_from_wav.py")
    calls = _JaxCalls()
    monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
        calls, mod.pwg_inference, [0, 0]))
    _jax_saved(monkeypatch, "pwgan/synthesize_from_wav.py",
               argv + ["--output-dir", tmp_path / "jax"], mod, calls)
    mean, std = np.load(dump["stat"])
    ext = jfeatures.LogMelFBank(sr=AUDIO["fs"], n_fft=AUDIO["n_fft"],
                                hop_length=AUDIO["n_shift"],
                                win_length=AUDIO["win_length"],
                                fmin=AUDIO["fmin"], fmax=AUDIO["fmax"],
                                n_mels=AUDIO["n_mels"])
    from parakeet_tpu.audio.codec import load_wav
    assert [r["frames"] for r in got["lines"]][1] == MAX_FRAMES
    for r, path in zip(got["lines"], wavs):
        want_mel = (ext.get_log_mel_fbank(load_wav(path, sr=AUDIO["fs"])[0])
                    - mean) / np.maximum(std, 1e-8)
        assert np.array_equal(r["mel"], want_mel.astype(np.float32))
        want = calls.saved[f"{path.stem}_gen"]
        assert r["samples"] == r["frames"] * HOP == len(want)
        assert Path(r["path"]).name == f"{path.stem}_gen.wav"
        _close(r["wav"], want, what=path.stem)


@pytest.fixture(scope="module")
def fs2(tmp_path_factory, dump):
    """FastSpeech2 snapshots over the dump's phone map, single-speaker and
    with the three speakers: every token two frames."""
    d = tmp_path_factory.mktemp("fs2")
    conf = _yaml(d / "fs2.yaml", **AUDIO,
                 model={**FS2_MODEL, "init_type": "xavier_uniform"})
    out = {"conf": conf}
    for spk in (False, True):
        kw = dict(num_speakers=3, spk_embed_dim=256) if spk else {}
        jm = JFS2(idim=N_PHONES, odim=10, **FS2_MODEL, **kw)
        flat = _flat(jm, 13, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
                     max_frames=32, spk_id=jnp.asarray([0]) if spk else None,
                     method=JFS2.inference)
        flat = _durations_of_two(
            flat, "params::duration_predictor::stack::linear", np.log(3.0))
        out[spk] = d / f"fs2_{int(spk)}.npz"
        save_pytree(out[spk], nest_flat(flat))
    return out


@pytest.mark.parametrize("speakers,impl,rel", [
    (False, "xla", 1e-5), (True, "pallas", PALLAS_WAV_REL_TOL)])
def test_fastspeech2_synthesize_matches_jax(dump, fs2, tmp_path,
                                            monkeypatch, speakers, impl,
                                            rel):
    """Each row's ids (cut to ``--max-text-len``; with ``--speaker-dict``
    its speaker) through the acoustic model and ``--fastspeech2-stat``:
    two frames a token, the vocoder's mels within 1e-5 of their range of
    the JAX CLI's, the wavs on the same noise within ``rel``."""
    conf, ckpt = dump[f"pwg_{impl}"]
    argv = ["--fastspeech2-config", fs2["conf"], "--fastspeech2-checkpoint",
            fs2[speakers], "--fastspeech2-stat", dump["stat"],
            "--pwg-config", conf, "--pwg-checkpoint", ckpt,
            "--test-metadata", dump["md"], "--phones-dict", dump["phones"],
            "--max-text-len", MAX_TEXT, "--max-frames", MAX_FRAMES]
    if speakers:
        argv += ["--speaker-dict", dump["spk"]]
    got = fs2_syn.main(_argv(*argv, "--output-dir", tmp_path / "port",
                             "--device", "cpu"))
    mod = _jax_recipe("fastspeech2/synthesize.py")
    calls = _JaxCalls()
    monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
        calls, mod.pwg_inference, [0] * len(ROWS)))
    _jax_saved(monkeypatch, "fastspeech2/synthesize.py",
               argv + ["--output-dir", tmp_path / "jax"], mod, calls)
    assert [len(r["ids"]) for r in got["lines"]] == [5, MAX_TEXT, 9]
    for r, mel in zip(got["lines"], calls.voc_mels):
        assert r["frames"] == 2 * len(r["ids"]) == mel.shape[0]
        _close(r["mel"], mel, what=f"{r['utt_id']} mel")
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == r["frames"] * HOP == len(want)
        _close(r["wav"], want, rel=rel, what=f"{r['utt_id']} wav")


def _wf_snapshot(d):
    """A WaveFlow YAML and a JAX-written snapshot with numpy-drawn weights
    (output projections nonzero)."""
    conf = _yaml(d / "wf.yaml", **AUDIO, model=WF_MODEL)
    jm = jwf.ConditionalWaveFlow(**WF_MODEL)
    flat = _flat(jm, 17, jnp.zeros((1, 16)), jnp.zeros((1, 4, 10)))
    ckpt = d / "wf.npz"
    save_pytree(ckpt, nest_flat(flat))
    return conf, ckpt


def _wf_noise_queue(monkeypatch, noises):
    """``jax.random.normal`` hands out ``noises`` in turn for their
    shapes (the port's draws), any other draw as it was."""
    real = jax.random.normal
    queue = list(noises)

    def normal(key, shape, *a, **kw):
        if queue and tuple(shape) == queue[0].shape:
            return jnp.asarray(queue.pop(0))
        return real(key, shape, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", normal)
    return queue


@pytest.fixture(scope="module")
def ar(tmp_path_factory, dump):
    """Tacotron2 and TransformerTTS YAMLs and JAX snapshots over the dump's
    phone map (no dropout), each with its stop logit's bias at -10 and at
    +10; the WaveFlow snapshot."""
    d = tmp_path_factory.mktemp("ar")
    out = {"t2_conf": _yaml(d / "t2.yaml", **AUDIO, model={
        **T2_MODEL, "d_mels": 10, "use_stop_token": True}),
        "tts_conf": _yaml(d / "tts.yaml", **AUDIO, model={
            **TTS_MODEL, "reduction_factor": 1}),
        "wf": _wf_snapshot(d)}
    ids, lens = jnp.ones((1, 6), jnp.int32), jnp.asarray([6])
    t2 = _flat(JT2(vocab_size=N_PHONES, d_mels=10, **T2_MODEL), 19, ids,
               lens, jnp.zeros((1, 4, 10)), jnp.asarray([4]),
               deterministic=False)
    tts = _flat(JTTS(idim=N_PHONES, odim=10, **TTS_MODEL), 23, ids, lens,
                jnp.zeros((1, 4, 10)), jnp.asarray([4]), deterministic=False)
    for bias in (-10.0, 10.0):
        t2["params::cell::stop_proj::bias"] = np.full_like(
            t2["params::cell::stop_proj::bias"], bias)
        tts["params::prob_out::bias"] = np.full_like(
            tts["params::prob_out::bias"], bias)
        for name, flat in (("t2", t2), ("tts", tts)):
            out[name, bias] = d / f"{name}_{int(bias)}.npz"
            save_pytree(out[name, bias], nest_flat(flat))
    return out


def _ar_vocoder(dump, ar, vocoder):
    if vocoder == "pwg":
        conf, ckpt = dump["pwg_xla"]
        return ["--pwg-config", conf, "--pwg-checkpoint", ckpt]
    if vocoder == "waveflow":
        conf, ckpt = ar["wf"]
        return ["--waveflow-config", conf, "--waveflow-checkpoint", ckpt]
    return []


@pytest.mark.parametrize("recipe,vocoder,bias", [
    ("tacotron2", None, -10.0), ("tacotron2", "pwg", 10.0),
    ("tacotron2", "waveflow", -10.0), ("transformer_tts", None, -10.0),
    ("transformer_tts", "pwg", 10.0)])
def test_ar_synthesize_matches_jax(dump, ar, tmp_path, monkeypatch, recipe,
                                   vocoder, bias):
    """Each row's ids decoded over ``--max-decoder-steps``: the stop frames
    equal (every step with the stop bias at -10, fewer at +10),
    the mels with ``--stat`` undone within 1e-5 of their range (written as
    .npy without a vocoder), the wavs on the same noise within 1e-5
    (Parallel WaveGAN) or 1e-4 (WaveFlow)."""
    name = "t2" if recipe == "tacotron2" else "tts"
    argv = ["--config", ar[f"{name}_conf"], "--checkpoint", ar[name, bias],
            "--stat", dump["stat"], "--test-metadata", dump["md"],
            "--phones-dict", dump["phones"], "--max-text-len", MAX_TEXT,
            "--max-decoder-steps", STEPS, *_ar_vocoder(dump, ar, vocoder)]
    port_main = {"tacotron2": t2_syn.main, "transformer_tts": tts_syn.main}
    got = port_main[recipe](_argv(*argv, "--output-dir", tmp_path / "port",
                                  "--device", "cpu"))
    lines = got["lines"]
    frames = lines[0]["frames"]
    assert [r["frames"] for r in lines] == [frames] * len(ROWS)
    assert (frames == STEPS) == (bias < 0)
    mod = _jax_recipe(f"{recipe}/synthesize.py")
    calls = _JaxCalls()
    if vocoder == "pwg":
        monkeypatch.setattr(mod, "pwg_inference", _pwg_with_port_noise(
            calls, mod.pwg_inference, [0] * len(ROWS)))
    if vocoder == "waveflow":
        t = frames * int(np.prod(WF_MODEL["upsample_factors"]))
        _wf_noise_queue(monkeypatch, [torch.randn(
            (1, t), generator=torch.Generator().manual_seed(0)).numpy()])
    _jax_saved(monkeypatch, f"{recipe}/synthesize.py",
               argv + ["--output-dir", tmp_path / "jax"], mod, calls)
    hop = {"pwg": HOP, "waveflow": 4}.get(vocoder)
    for r in lines:
        if vocoder is None:
            want = np.load(tmp_path / "jax" / f"{r['utt_id']}.npy")
            assert want.shape[0] == r["frames"]
            _close(np.load(r["path"]), want, what=r["utt_id"])
            continue
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == r["frames"] * hop == len(want)
        _close(r["wav"], want, rel=WF_REL_TOL if vocoder == "waveflow"
               else 1e-5, what=r["utt_id"])


def test_waveflow_synthesize_matches_jax(dump, ar, tmp_path, monkeypatch):
    """Two mel files (one longer than ``--max-frames``) padded to it and
    sampled with ``--sigma 0.8`` on the port's noise, drawn for each file
    in turn from one generator seeded ``--seed 3``: the wavs within 1e-4
    of their range, cut to each file's frames."""
    mels = tmp_path / "mels"
    mels.mkdir()
    rng = np.random.default_rng(29)
    for name, frames in (("a", 24), ("b", 40)):
        np.save(mels / f"{name}.npy",
                rng.standard_normal((frames, 10)).astype(np.float32))
    conf, ckpt = ar["wf"]
    max_frames = 32
    argv = ["--config", conf, "--checkpoint", ckpt, "--input", mels,
            "--max-frames", max_frames, "--sigma", "0.8", "--seed", "3"]
    got = wf_syn.main(_argv(*argv, "--output", tmp_path / "port",
                            "--device", "cpu"))
    gen = torch.Generator().manual_seed(3)
    t = max_frames * int(np.prod(WF_MODEL["upsample_factors"]))
    noises = [torch.zeros((1, t)).normal_(generator=gen).numpy()
              for _ in range(2)]
    assert not np.array_equal(*noises)
    queue = _wf_noise_queue(monkeypatch, noises)
    calls = _JaxCalls()
    with jax.disable_jit():         # one noise a file, not a traced one
        _jax_saved(monkeypatch, "waveflow/synthesize.py",
                   argv + ["--output", tmp_path / "jax"], calls=calls)
    assert not queue
    assert [r["frames"] for r in got["lines"]] == [24, max_frames]
    for r in got["lines"]:
        want = calls.saved[r["utt_id"]]
        assert r["samples"] == r["frames"] * 4 == len(want)
        _close(r["wav"], want, rel=WF_REL_TOL, what=r["utt_id"])


def _fs2_export_argv(zh, text, out, export, impl="pallas"):
    """The FastSpeech2 e2e twin's (or JAX CLI's) flags: three speakers,
    both statistics, the Parallel WaveGAN stack ``impl``,
    ``--export-dir``."""
    conf, ckpt = zh[f"pwg_{impl}"]
    return _argv("--fastspeech2-config", zh["conf"],
                 "--fastspeech2-checkpoint", zh["fs2_spk"],
                 "--speaker-dict", zh["dir"] / "spk.txt", "--spk-id", "1",
                 "--fastspeech2-stat", zh["am_stat"], "--pwg-stat",
                 zh["voc_stat"], "--pwg-config", conf, "--pwg-checkpoint",
                 ckpt, "--phones-dict", zh["maps"]["phones"], "--text",
                 text, "--output-dir", out, "--max-text-len", MAX_TEXT,
                 "--max-frames", MAX_FRAMES, "--export-dir", export,
                 "--device", "cpu")


def _ss_export_argv(zh, ss, text, out, export, impl="pallas"):
    conf, ckpt = zh[f"pwg_{impl}"]
    return _argv("--config", ss["conf"], "--checkpoint", ss["ckpt"],
                 "--stat", zh["am_stat"], "--pwg-config", conf,
                 "--pwg-checkpoint", ckpt, "--phones-dict",
                 zh["maps"]["tone_phones"], "--tones-dict",
                 zh["maps"]["tones"], "--text", text, "--output-dir", out,
                 "--max-text-len", MAX_TEXT, "--max-frames", MAX_FRAMES,
                 "--export-dir", export, "--device", "cpu")


@pytest.fixture(scope="module")
def exported(zh, ss, tmp_path_factory):
    """The port's e2e twins run once each with ``--export-dir`` on the
    CPU over the e2e tests' sentences: {recipe: (argv builder, export
    directory, the twin's result)}."""
    d = tmp_path_factory.mktemp("exported")
    out = {}
    for recipe, build, main, text in (
            ("fastspeech2", lambda *a: _fs2_export_argv(zh, *a),
             fs2_e2e.main, zh["dir"] / "zh.txt"),
            ("speedyspeech", lambda *a: _ss_export_argv(zh, ss, *a),
             ss_e2e.main, zh["dir"] / "zh_ss.txt")):
        export = d / recipe
        out[recipe] = (build, export, main(build(text, d / f"{recipe}_out",
                                                 export)))
    return out


def _load(path):
    return torch.export.load(path).module()


@pytest.mark.parametrize("recipe", ["fastspeech2", "speedyspeech"])
def test_export_matches_jax_export(zh, exported, tmp_path, monkeypatch,
                                   recipe):
    """``--export-dir`` on the CPU against the JAX CLI's: the port's
    acoustic program (statistics and speaker baked in) on the same padded
    ids (and tones) within 1e-5 of the range of ``jax.export``'s, its
    frames equal; its vocoder (the recipe's 'pallas' stack, K1's plain
    version, against the JAX 'xla' stack of the same weights: both round
    the stack's operands to bf16, at other points) on the JAX program's
    mel and the same noise within 2^-8; each records its
    device and shapes, and neither holds K1's operator (the CPU export
    holds its plain version)."""
    build, export, _ = exported[recipe]
    ids, tones = [2, 5, 7, 3, 9, 4], [1, 2, 3, 1, 4, 0]
    inputs = [ids, [len(ids)] if recipe == "fastspeech2" else tones]
    text = tmp_path / "one.txt"          # the JAX CLI vocodes every line
    text.write_text(zh["dir"].joinpath("zh_ss.txt").read_text()
                    .splitlines()[0] + "\n")
    _run_jax(monkeypatch, f"{recipe}/synthesize_e2e.py",
             build(text, tmp_path / "jo", tmp_path / "je", "xla"),
             _JaxCalls())
    padded = []
    for seq in inputs:
        row = np.zeros((1, MAX_TEXT), np.int64)
        row[0, :len(seq)] = seq
        padded.append(row if len(seq) > 1 else np.asarray(seq, np.int64))
    j_am, j_voc = (jexport.deserialize((tmp_path / "je" / f"{name}.jaxexport")
                                       .read_bytes())
                   for name in (recipe, "pwgan"))
    want_mel, want_n = j_am.call(*[jnp.asarray(a) for a in padded])
    mel, n = _load(export / f"{recipe}.pt2")(
        *[torch.from_numpy(a) for a in padded])
    assert int(n[0]) == int(want_n[0]) > 0
    _close(mel, want_mel, what="mel")
    noise = _port_noise(0, MAX_FRAMES * HOP)
    want_wav = j_voc.call(want_mel, jnp.asarray(noise))
    wav = _load(export / "pwgan.pt2")(
        torch.from_numpy(np.asarray(want_mel)), torch.from_numpy(noise))
    assert wav.shape == want_wav.shape == (1, MAX_FRAMES * HOP)
    _close(wav, want_wav, rel=PALLAS_WAV_REL_TOL, what="wav")
    for name in (recipe, "pwgan"):
        path = export / f"{name}.pt2"
        record = synthesis.export_record(path)
        assert record["device"] == "cpu" and record["program"] == name
        assert record["max_frames"] == MAX_FRAMES
        assert record.get("max_text_len", MAX_TEXT) == MAX_TEXT
        assert record.get("hop", HOP) == HOP
        assert "pwg_residual_stack" not in str(torch.export.load(path).graph)


@pytest.mark.parametrize("recipe", ["fastspeech2", "speedyspeech"])
def test_inference_matches_synthesize_e2e(zh, exported, tmp_path, recipe):
    """``inference.py`` on the programs that ``synthesize_e2e.py
    --export-dir`` wrote, over the same lines: the same ids and frames,
    the mel (in the vocoder's domain) bit for bit the twin's, and each wav
    bit for bit the eager vocoder's on the exported acoustic program's
    mel and the same noise (for SpeedySpeech, whose twin vocodes the whole
    capacity on the same seed-0 noise, the twin's own wav)."""
    _, export, e2e = exported[recipe]
    conf, ckpt = zh["pwg_pallas"]
    if recipe == "fastspeech2":
        got = fs2_inf.main(_argv(
            "--export-dir", export, "--phones-dict", zh["maps"]["phones"],
            "--text", zh["dir"] / "zh.txt", "--output-dir", tmp_path / "i",
            "--fs", AUDIO["fs"], "--device", "cpu"))
        voc_norm = ZScore(*np.load(zh["voc_stat"]))
    else:
        got = ss_inf.main(_argv(
            "--export-dir", export, "--phones-dict",
            zh["maps"]["tone_phones"], "--tones-dict", zh["maps"]["tones"],
            "--text", zh["dir"] / "zh_ss.txt", "--output-dir",
            tmp_path / "i", "--fs", AUDIO["fs"], "--device", "cpu"))
    assert e2e["export_s"] > 0 and len(got["lines"]) == 3
    assert ([(r["utt_id"], r["ids"], r["frames"]) for r in got["lines"]]
            == [(r["utt_id"], r["ids"], r["frames"]) for r in e2e["lines"]])
    speech = got["speech"]
    voc = fs2_e2e.build_vocoder(conf, ckpt, torch.device("cpu"))
    for r, e in zip(got["lines"], e2e["lines"]):
        assert r["samples"] == r["frames"] * HOP and Path(r["path"]).is_file()
        if recipe == "speedyspeech":
            assert r["tones"] == e["tones"]
            assert np.array_equal(r["mel"], e["mel"])
            assert np.array_equal(r["wav"], e["wav"])
            continue
        assert np.array_equal(r["mel"], voc_norm.transform(
            torch.from_numpy(e["mel"])).numpy())
        speech.program.load(r["ids"])
        mel, _ = speech.program.eager()
        with torch.no_grad():
            want = pwg_inference(voc, mel, noise=speech.noise)
        assert np.array_equal(r["wav"], want[0, :r["samples"]].numpy())


def test_inference_refuses_what_it_cannot_run(zh, exported, tmp_path):
    """A program recorded as made for the card, on the CPU; a directory of
    jax.export's files only; a directory without programs: each a
    SystemExit naming the reason, before anything runs."""
    export = tmp_path / "e"
    shutil.copytree(exported["fastspeech2"][1], export)
    argv = _argv("--phones-dict", zh["maps"]["phones"], "--text",
                 zh["dir"] / "zh.txt", "--output-dir", tmp_path / "i",
                 "--device", "cpu")
    path = export / "pwgan.pt2"
    record = synthesis.export_record(path)
    record.pop("device")
    synthesis.save_export(path, torch.export.load(path),
                          torch.device("cuda"), **record)
    with pytest.raises(SystemExit, match="exported for 'cuda', not 'cpu'"):
        fs2_inf.main(["--export-dir", str(export)] + argv)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for name in ("fastspeech2", "pwgan"):
        (jdir / f"{name}.jaxexport").write_bytes(b"\0")
    with pytest.raises(SystemExit, match="jax.export"):
        fs2_inf.main(["--export-dir", str(jdir)] + argv)
    with pytest.raises(SystemExit, match="has no speedyspeech.pt2"):
        ss_inf.main(["--export-dir", str(export)] + argv)
    assert not (tmp_path / "i").exists()


def test_k1_op_fake_kernel_states_the_reference_outputs():
    """K1's registered operator on meta tensors (its fake kernel) gives
    the shapes and types of ``fused_residual_stack_reference``'s outputs;
    it has no CPU kernel, and ``fused_residual_stack`` takes CPU tensors
    to the plain version before it."""
    from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
    stack = ResidualStack(layers=4, stacks=2, residual_channels=32,
                          gate_channels=64, skip_channels=32,
                          aux_channels=13).requires_grad_(False)
    x, c = torch.randn(2, 21, 32), torch.randn(2, 21, 13)
    kw = dict(dilations=stack.dilations(), stacks=2)
    want = pwg_stack.fused_residual_stack_reference(
        x, c, stack.fused_weights(), **kw)
    got = pwg_stack.fused_residual_stack(x, c, stack.fused_weights(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    weights = {k: None if v is None else v.to("meta")
               for k, v in stack.fused_weights().items()}
    wg, wso, bso = pwg_stack.pack_stack_weights(weights, 32, 13)
    op = torch.ops.parakeet_tpu_torch.pwg_residual_stack
    meta = op(x.to("meta", torch.bfloat16), c.to("meta", torch.bfloat16),
              wg.to(torch.bfloat16), wso.to(torch.bfloat16), bso,
              list(kw["dilations"]), 2)
    for m, w in zip(meta, want):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (w.shape, w.dtype)
    with pytest.raises(NotImplementedError):
        op(x.bfloat16(), c.bfloat16(),
           torch.zeros(wg.shape, dtype=torch.bfloat16),
           torch.zeros(wso.shape, dtype=torch.bfloat16),
           torch.zeros(bso.shape), list(kw["dilations"]), 2)


def test_new_clis_without_device_cpu_raise_without_a_card(dump, fs2, ar,
                                                          tmp_path):
    """The default device is the card: without one, each synthesis and
    inference CLI raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal of a machine without a card")
    conf, ckpt = dump["pwg_xla"]
    wf_conf, wf_ckpt = ar["wf"]
    out = tmp_path / "out"
    runs = [
        (pwg_syn.main, ["--config", conf, "--checkpoint", ckpt,
                        "--test-metadata", dump["md"], "--output-dir", out]),
        (copy_syn.main, ["--config", conf, "--checkpoint", ckpt, "--stats",
                         dump["stat"], "--input-wav", "x.wav",
                         "--output-dir", out]),
        (fs2_syn.main, ["--fastspeech2-config", fs2["conf"],
                        "--fastspeech2-checkpoint", fs2[False],
                        "--pwg-config", conf, "--pwg-checkpoint", ckpt,
                        "--test-metadata", dump["md"], "--phones-dict",
                        dump["phones"], "--output-dir", out]),
        (t2_syn.main, ["--config", ar["t2_conf"], "--checkpoint",
                       ar["t2", -10.0], "--test-metadata", dump["md"],
                       "--phones-dict", dump["phones"], "--output-dir",
                       out]),
        (tts_syn.main, ["--config", ar["tts_conf"], "--checkpoint",
                        ar["tts", -10.0], "--test-metadata", dump["md"],
                        "--phones-dict", dump["phones"], "--output-dir",
                        out]),
        (wf_syn.main, ["--config", wf_conf, "--checkpoint", wf_ckpt,
                       "--input", tmp_path, "--output", out]),
        (fs2_inf.main, ["--export-dir", tmp_path, "--phones-dict",
                        dump["phones"], "--text", "x.txt", "--output-dir",
                        out]),
        (ss_inf.main, ["--export-dir", tmp_path, "--phones-dict",
                       dump["phones"], "--text", "x.txt", "--output-dir",
                       out])]
    for main, argv in runs:
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(_argv(*argv))
    assert not out.exists()
