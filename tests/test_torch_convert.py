"""The port's Paddle checkpoint converters and their CLIs against the JAX
package's.

- Each of the eight converters of ``parakeet_tpu_torch/utils/convert.py``
  on ``tools/golden/fixtures.py``'s Paddle-layout dicts gives a flat tree
  equal, key for key and bit for bit, to the JAX ``convert.py``'s tree
  flattened by the JAX ``flatten_tree``.
- Each ``parakeet_tpu_torch.tools.convert_*_checkpoint`` CLI writes a file
  that ``bridge.load_checkpoint_params`` loads into the port's model, whose
  output on numpy-seeded inputs matches the JAX model's on the JAX
  converter's params (float32 both; 1e-4 of each output's range, at least
  1e-4, for sums in other orders).  The PWG CLI strips a ``generator.``
  scope, and runs as ``python -m``.
- The ``verify_parity`` twin exits 0 on a self-golden and 1 on a perturbed
  one, as ``tests/test_convert.py::test_verify_parity_cli`` holds JAX's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.training.checkpoint import flatten_tree
from parakeet_tpu.utils import convert as jc
from parakeet_tpu_torch.training.checkpoint import (flatten_nested,
                                                    load_variables)
from parakeet_tpu_torch.utils import convert as tc

import test_torch_golden_parity as gp
from tools.golden import fixtures

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _nonlinear_pwg_state():
    """The PWG fixture with the upsampler's convs where a dump with a
    nonlinearity after each scale holds them (up_layers.{3i + 1})."""
    state, cfg = fixtures.pwg_state()
    out = {}
    for k, v in state.items():
        head = "upsample_net.upsample.up_layers."
        if k.startswith(head):
            idx, rest = k[len(head):].split(".", 1)
            k = f"{head}{int(idx) // 2 * 3 + 1}.{rest}"
        out[k] = v
    return out, cfg


def _pwg_kw(cfg):
    return dict(layers=cfg["layers"], upsample_scales=cfg["upsample_scales"])


# name -> (fixture, converter kwargs of its config)
CONVERTERS = {
    "pwg_generator": (fixtures.pwg_state, _pwg_kw, "convert_pwg_generator"),
    "pwg_generator_nonlinear": (
        _nonlinear_pwg_state,
        lambda c: dict(_pwg_kw(c), nonlinear_activation=True),
        "convert_pwg_generator"),
    "pwg_discriminator": (fixtures.pwg_disc_state,
                          lambda c: dict(layers=c["layers"]),
                          "convert_pwg_discriminator"),
    "fastspeech2": (fixtures.fastspeech2_state, lambda c: dict(
        elayers=c["elayers"], dlayers=c["dlayers"], aheads=c["heads"],
        postnet_layers=c["postnet_layers"], predictor_layers=2,
        pitch_predictor_layers=2, energy_predictor_layers=2),
        "convert_fastspeech2"),
    "waveflow": (fixtures.waveflow_state, lambda c: dict(
        n_flows=c["n_flows"], n_layers=c["n_layers"],
        upsample_factors=c["factors"]), "convert_waveflow"),
    "ge2e": (fixtures.ge2e_state, lambda c: dict(num_layers=c["num_layers"]),
             "convert_ge2e"),
    "speedyspeech": (fixtures.speedyspeech_state, lambda c: dict(
        encoder_dilations=c["enc_dil"], decoder_dilations=c["dec_dil"]),
        "convert_speedyspeech"),
    "tacotron2": (fixtures.tacotron2_state, lambda c: dict(
        encoder_conv_layers=c["encoder_conv_layers"],
        postnet_conv_layers=c["postnet_conv_layers"], use_stop_token=True),
        "convert_tacotron2"),
    "transformer_tts": (fixtures.transformer_tts_state, lambda c: dict(
        elayers=1, dlayers=1, aheads=c["heads"], dprenet_layers=2,
        postnet_layers=2), "convert_transformer_tts"),
}


def _trees(out):
    """A converter's result as (params, batch_stats or None)."""
    return out if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax_bitwise(name):
    fixture, kw, fn = CONVERTERS[name]
    state, cfg = fixture()
    params, stats = _trees(getattr(tc, fn)(state, **kw(cfg)))
    got = tc.checkpoint_arrays(params, stats)
    jparams, jstats = _trees(getattr(jc, fn)(state, **kw(cfg)))
    want = flatten_tree({"params": jparams, **(
        {} if jstats is None else {"batch_stats": jstats})})
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


# ------------------------------------------------ CLIs against JAX models

def _j(a):
    return jnp.asarray(np.asarray(a))


def _jvars(params, stats=None):
    out = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    if stats is not None:
        out["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, stats)
    return out


def jax_pwg(state, cfg):
    from parakeet_tpu.models import PWGGenerator
    gen = PWGGenerator(
        layers=cfg["layers"], stacks=cfg["stacks"],
        residual_channels=cfg["residual_channels"],
        gate_channels=cfg["gate_channels"],
        skip_channels=cfg["skip_channels"], aux_channels=cfg["aux_channels"],
        aux_context_window=cfg["aux_context_window"],
        upsample_scales=cfg["upsample_scales"])
    noise, mel = gp.pwg_inputs(cfg)
    wav = gen.apply(_jvars(jc.convert_pwg_generator(state, **_pwg_kw(cfg))),
                    _j(noise), _j(mel))
    return {"waveform": wav}


def jax_fastspeech2(state, cfg):
    from parakeet_tpu.models import FastSpeech2
    model = FastSpeech2(
        idim=cfg["vocab"], odim=cfg["odim"], adim=cfg["adim"],
        aheads=cfg["heads"], elayers=1, eunits=cfg["eunits"], dlayers=1,
        dunits=cfg["eunits"], postnet_layers=2, postnet_chans=8,
        postnet_filts=5, duration_predictor_chans=cfg["adim"],
        pitch_predictor_layers=2, pitch_predictor_chans=cfg["adim"],
        energy_predictor_chans=cfg["adim"])
    x = gp.fs2_inputs(cfg)
    out = model.apply(
        _jvars(*jc.convert_fastspeech2(
            state, **CONVERTERS["fastspeech2"][1](cfg))),
        _j(x["text"]), _j(x["ilens"]), _j(x["speech"]), _j(x["olens"]),
        _j(x["dur"]), _j(x["pitch"]), _j(x["energy"]), deterministic=True)
    return {k: out[k] for k in ("before_outs", "after_outs", "d_outs",
                                "p_outs", "e_outs")}


def jax_tacotron2(state, cfg):
    from parakeet_tpu.models.tacotron2 import Tacotron2
    model = Tacotron2(
        vocab_size=cfg["vocab"], d_mels=cfg["d_mels"],
        d_encoder=cfg["d_enc"],
        encoder_conv_layers=cfg["encoder_conv_layers"],
        encoder_kernel_size=3, d_prenet=cfg["d_prenet"],
        d_attention_rnn=cfg["d_att_rnn"], d_decoder_rnn=cfg["d_dec_rnn"],
        attention_filters=cfg["filters"],
        attention_kernel_size=cfg["k_att"], d_attention=cfg["d_att"],
        d_postnet=8, postnet_kernel_size=3,
        postnet_conv_layers=cfg["postnet_conv_layers"], reduction_factor=1,
        use_stop_token=True, p_prenet_dropout=0.0, p_encoder_dropout=0.0,
        p_attention_dropout=0.0, p_decoder_dropout=0.0,
        p_postnet_dropout=0.0)
    x = gp.t2_inputs(cfg)
    out = model.apply(
        _jvars(*jc.convert_tacotron2(state,
                                     **CONVERTERS["tacotron2"][1](cfg))),
        _j(x["text"]), _j(x["ilens"]), _j(x["mels"]), _j(x["olens"]),
        deterministic=True, rngs={"dropout": jax.random.PRNGKey(2)})
    res = {k: out[k] for k in ("mel_output", "mel_outputs_postnet",
                               "alignments")}
    res["stop_logits"] = np.asarray(out["stop_logits"]).reshape(2, -1)
    return res


def jax_speedyspeech(state, cfg):
    from parakeet_tpu.models.speedyspeech import SpeedySpeech
    model = SpeedySpeech(
        vocab_size=cfg["vocab"], encoder_hidden_size=cfg["hidden"],
        encoder_dilations=cfg["enc_dil"],
        duration_predictor_hidden_size=cfg["hidden"],
        decoder_hidden_size=cfg["hidden"], decoder_output_size=cfg["odim"],
        decoder_dilations=cfg["dec_dil"], tone_size=cfg["tones"])
    x = gp.ss_inputs(cfg)
    out = model.apply(
        _jvars(*jc.convert_speedyspeech(
            state, **CONVERTERS["speedyspeech"][1](cfg))),
        _j(x["text"]), _j(x["durs"]), _j(x["tones"]), max_frames=x["tot"],
        deterministic=True)
    return {k: out[k] for k in ("mel", "log_durations")}


def jax_waveflow(state, cfg):
    from parakeet_tpu.models.waveflow import ConditionalWaveFlow
    model = ConditionalWaveFlow(
        upsample_factors=cfg["factors"], n_flows=cfg["n_flows"],
        n_layers=cfg["n_layers"], n_group=cfg["n_group"],
        channels=cfg["channels"], n_mels=cfg["n_mels"])
    audio, mel = gp.wf_inputs(cfg)
    z, logdet = model.apply(_jvars(jc.convert_waveflow(
        state, **CONVERTERS["waveflow"][1](cfg))), _j(audio), _j(mel))
    return {"z": z, "log_det": np.asarray(logdet).sum()}


def jax_transformer_tts(state, cfg):
    from parakeet_tpu.models.transformer_tts import TransformerTTS
    model = TransformerTTS(
        idim=cfg["idim"], odim=cfg["odim"], adim=cfg["adim"],
        aheads=cfg["heads"], elayers=1, eunits=cfg["units"], dlayers=1,
        dunits=cfg["units"], eprenet_conv_layers=0,
        dprenet_units=cfg["dp_units"], postnet_layers=2, postnet_chans=8,
        postnet_filts=3, reduction_factor=1, dprenet_dropout_rate=0.0)
    x = gp.tt_inputs(cfg)
    out = model.apply(
        _jvars(*jc.convert_transformer_tts(
            state, **CONVERTERS["transformer_tts"][1](cfg))),
        _j(x["text"]), _j(x["tl"]), _j(x["mels"]), _j(x["ol"]),
        deterministic=True, rngs={"dropout": jax.random.PRNGKey(2)})
    return {k: out[k] for k in ("before_outs", "after_outs", "stop_logits")}


def jax_ge2e(state, cfg):
    from parakeet_tpu.models.lstm_speaker_encoder import (
        LSTMSpeakerEncoder, ge2e_loss)
    model = LSTMSpeakerEncoder(n_mels=cfg["n_mels"],
                               num_layers=cfg["num_layers"],
                               hidden_size=cfg["hidden_size"],
                               output_size=cfg["output_size"])
    utts, n = gp.ge2e_inputs(cfg)
    embeds, (w, b) = model.apply(
        _jvars(jc.convert_ge2e(state, num_layers=cfg["num_layers"])),
        _j(utts), n_speakers=n, method=LSTMSpeakerEncoder.embed_sequences)
    loss, aux = ge2e_loss(embeds, w, b)
    return {"embeds": np.asarray(embeds).reshape(len(utts), -1),
            "sim": np.asarray(aux["sim"]).reshape(len(utts), n),
            "loss": np.asarray(loss).reshape(1)}


# family -> (fixture, yaml text of its config or None, extra CLI argv,
#            port forward, JAX forward)
CLIS = {
    "pwg": (fixtures.pwg_state, lambda c: (
        "generator_params:\n"
        f"  layers: {c['layers']}\n"
        f"  upsample_scales: {list(c['upsample_scales'])}\n"), [],
        gp.port_pwg, jax_pwg),
    "fastspeech2": (fixtures.fastspeech2_state, lambda c: (
        "model:\n"
        f"  elayers: {c['elayers']}\n  dlayers: {c['dlayers']}\n"
        f"  aheads: {c['heads']}\n  postnet_layers: {c['postnet_layers']}\n"
        "  duration_predictor_layers: 2\n  pitch_predictor_layers: 2\n"
        "  energy_predictor_layers: 2\n"), [],
        gp.port_fastspeech2, jax_fastspeech2),
    "ge2e": (fixtures.ge2e_state, None, ["--num-layers", "3"],
             gp.port_ge2e, jax_ge2e),
    "speedyspeech": (fixtures.speedyspeech_state, lambda c: (
        "model:\n"
        f"  encoder_dilations: {list(c['enc_dil'])}\n"
        f"  decoder_dilations: {list(c['dec_dil'])}\n"), [],
        gp.port_speedyspeech, jax_speedyspeech),
    "tacotron2": (fixtures.tacotron2_state, lambda c: (
        "model:\n"
        f"  encoder_conv_layers: {c['encoder_conv_layers']}\n"
        f"  postnet_conv_layers: {c['postnet_conv_layers']}\n"
        "  use_stop_token: true\n"), [],
        gp.port_tacotron2, jax_tacotron2),
    "transformer_tts": (fixtures.transformer_tts_state, lambda c: (
        "model:\n  elayers: 1\n  dlayers: 1\n"
        f"  aheads: {c['heads']}\n  dprenet_layers: 2\n"
        "  postnet_layers: 2\n"), [],
        gp.port_transformer_tts, jax_transformer_tts),
    "waveflow": (fixtures.waveflow_state, lambda c: (
        "model:\n"
        f"  n_flows: {c['n_flows']}\n  n_layers: {c['n_layers']}\n"
        f"  upsample_factors: {list(c['factors'])}\n"), [],
        gp.port_waveflow, jax_waveflow),
}


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = 1e-4 * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _run_cli(family, tmp_path, state, cfg, input_state=None):
    import importlib
    _, yaml_text, extra, _, _ = CLIS[family]
    inp = tmp_path / f"{family}_paddle.npz"
    np.savez(inp, **(state if input_state is None else input_state))
    argv = ["--input", str(inp), "--output", str(tmp_path / "out.npz"),
            *extra]
    if yaml_text is not None:
        conf = tmp_path / "conf.yaml"
        conf.write_text(yaml_text(cfg))
        argv += ["--config", str(conf)]
    cli = importlib.import_module(
        f"parakeet_tpu_torch.tools.convert_{family}_checkpoint")
    return cli.main(argv)


@pytest.mark.parametrize("family", sorted(CLIS))
def test_cli_checkpoint_loads_and_matches_jax(family, tmp_path):
    fixture, _, _, port_fwd, jax_fwd = CLIS[family]
    state, cfg = fixture()
    path = _run_cli(family, tmp_path, state, cfg)
    flat = flatten_nested(load_variables(path))
    got = port_fwd(flat, cfg)
    want = jax_fwd(state, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], f"{family}.{k}")


def test_pwg_cli_strips_the_generator_scope(tmp_path):
    """A full GAN dump (generator. and discriminator. keys) converts to
    the generator's checkpoint, the same file as the generator's own dump
    gives."""
    state, cfg = fixtures.pwg_state()
    disc, _ = fixtures.pwg_disc_state()
    gan = {**{f"generator.{k}": v for k, v in state.items()},
           **{f"discriminator.{k}": v for k, v in disc.items()}}
    own = flatten_nested(load_variables(_run_cli("pwg", tmp_path, state,
                                                 cfg)))
    scoped = flatten_nested(load_variables(_run_cli(
        "pwg", tmp_path, state, cfg, input_state=gan)))
    assert sorted(own) == sorted(scoped)
    for k in own:
        np.testing.assert_array_equal(own[k], scoped[k], err_msg=k)


def test_pwg_cli_runs_as_a_module(tmp_path):
    state, cfg = fixtures.pwg_state()
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **state)
    conf = tmp_path / "conf.yaml"
    conf.write_text(CLIS["pwg"][1](cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-m",
         "parakeet_tpu_torch.tools.convert_pwg_checkpoint", "--input",
         str(inp), "--config", str(conf), "--output", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-1500:]
    got = flatten_nested(load_variables(out))
    want = tc.checkpoint_arrays(tc.convert_pwg_generator(state,
                                                         **_pwg_kw(cfg)))
    assert sorted(got) == sorted(want)


# ------------------------------------------------------- verify_parity

def test_verify_parity_cli(tmp_path, capsys):
    """MSE 0 on a self-golden (exit 0), a perturbed golden fails (exit
    1), one JSON line each."""
    from parakeet_tpu_torch.models import FastSpeech2
    from parakeet_tpu_torch.nn.initializer import init_flax_defaults_
    from parakeet_tpu_torch.tools import verify_parity
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.training.checkpoint import save_pytree
    kw = dict(adim=16, aheads=2, elayers=1, eunits=24, dlayers=1, dunits=24,
              postnet_layers=1, postnet_chans=8, postnet_filts=3,
              duration_predictor_chans=8, pitch_predictor_chans=8,
              energy_predictor_chans=8)
    model = FastSpeech2(idim=11, odim=6, **kw)
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    model.eval()
    text = torch.as_tensor(np.random.default_rng(0).integers(1, 11, (1, 5)))
    with torch.no_grad():
        out = model.inference(text, torch.tensor([5]), max_frames=16,
                              min_duration=0)
    save_pytree(tmp_path / "ck.npz", flax_arrays(model))
    mel = out["after_outs"].numpy()[0]
    (tmp_path / "conf.yaml").write_text(
        "n_mels: 6\nmodel:\n" + "".join(f"  {k}: {v}\n"
                                        for k, v in kw.items()))
    argv = ["--model", "fastspeech2", "--config",
            str(tmp_path / "conf.yaml"), "--checkpoint",
            str(tmp_path / "ck.npz"), "--golden",
            str(tmp_path / "golden.npz"), "--device", "cpu"]
    np.savez(tmp_path / "golden.npz", text=text.numpy(), text_lengths=[5],
             mel=mel)
    assert verify_parity.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pass"] is True and line["value"] == 0.0
    np.savez(tmp_path / "golden.npz", text=text.numpy(), text_lengths=[5],
             mel=mel + 1.0)
    assert verify_parity.main(argv) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pass"] is False
