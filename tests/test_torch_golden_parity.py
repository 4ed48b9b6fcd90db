"""The port held to the repository's torch golden oracles of the reference
math (``tools/golden/``, PARITY.md): the counterpart of
``tools/golden/run_parity.py::CHECKS`` for ``parakeet_tpu_torch``.

Each case builds a fixture's Paddle-layout state dict
(``tools/golden/fixtures.py``), converts it with the port's
``utils/convert.py``, loads the flat tree into the port's model through
the bridge, runs the same numpy-seeded inputs through the model and the
float64 oracle, and compares the outputs over their valid regions.  The
``_grads`` cases compare every parameter's gradient by Paddle name: the
oracle's Paddle gradients go through the port's converter (its layout
transforms are pure reindexings) and the port's through
``bridge.flax_grads``, onto the same keys.  The port runs float32 on the
CPU (its kernels' plain versions) and the oracles float64, so the
tolerance bounds float32 rounding: ``TOL`` = 1e-3 max abs difference, the
JAX package's (``tests/test_golden_parity.py``).  The ``*_inputs`` and
``port_*`` helpers are shared with ``tests/test_torch_convert.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from parakeet_tpu_torch import models as tm  # noqa: E402
from parakeet_tpu_torch.bridge import flax_grads, load_flax_params  # noqa
from parakeet_tpu_torch.models.pwg_updater import (  # noqa: E402
    discriminator_objective, generator_objective)
from parakeet_tpu_torch.utils import convert as tc  # noqa: E402
from tools.golden import fixtures  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-3


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _f(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _np(t):
    return t.detach().double().numpy()


def _maxdiff(ours, gold, valid_lens=None) -> float:
    """max |ours - gold| over the valid prefix of each row (every element
    without ``valid_lens``)."""
    ours = np.asarray(ours, np.float64)
    gold = np.asarray(gold, np.float64)
    if valid_lens is None:
        return float(np.abs(ours - gold).max())
    return max(float(np.abs(ours[b, :n] - gold[b, :n]).max())
               for b, n in enumerate(valid_lens))


def _grads_diff(model, gold_params) -> float:
    """max abs difference between the port's gradients and the converted
    oracle gradients, key for key: the key sets must be equal."""
    ours = flax_grads(model)
    gold = tc.checkpoint_arrays(gold_params)
    assert sorted(ours) == sorted(gold)
    return max(float(np.abs(ours[k].astype(np.float64)
                            - gold[k].reshape(ours[k].shape)).max())
               for k in ours)


def _loaded(model, params, batch_stats=None):
    load_flax_params(model, tc.checkpoint_arrays(params, batch_stats))
    return model


# ------------------------------------------------------------------ PWG

def pwg_generator(cfg, **kw):
    return tm.PWGGenerator(
        layers=cfg["layers"], stacks=cfg["stacks"],
        residual_channels=cfg["residual_channels"],
        gate_channels=cfg["gate_channels"],
        skip_channels=cfg["skip_channels"], aux_channels=cfg["aux_channels"],
        aux_context_window=cfg["aux_context_window"],
        upsample_scales=cfg["upsample_scales"], **kw)


def pwg_inputs(cfg):
    rng = np.random.default_rng(0)
    up = int(np.prod(cfg["upsample_scales"]))
    w = cfg["aux_context_window"]
    noise = rng.standard_normal((1, 5 * up, 1)).astype(np.float32)
    mel = rng.standard_normal(
        (1, 5 + 2 * w, cfg["aux_channels"])).astype(np.float32)
    return noise, mel


def port_pwg(flat, cfg):
    gen = pwg_generator(cfg)
    load_flax_params(gen, flat)
    noise, mel = pwg_inputs(cfg)
    with torch.no_grad():
        return {"waveform": _np(gen(_f(noise), _f(mel)))}


def check_pwg():
    from tools.golden.pwg import golden_pwg_forward
    state, cfg = fixtures.pwg_state()
    flat = tc.checkpoint_arrays(tc.convert_pwg_generator(
        state, layers=cfg["layers"], upsample_scales=cfg["upsample_scales"]))
    ours = port_pwg(flat, cfg)
    noise, mel = pwg_inputs(cfg)
    gold = golden_pwg_forward(
        state, noise.transpose(0, 2, 1), mel.transpose(0, 2, 1),
        layers=cfg["layers"], stacks=cfg["stacks"],
        upsample_scales=cfg["upsample_scales"],
        aux_context_window=cfg["aux_context_window"]).transpose(0, 2, 1)
    return {"waveform": _maxdiff(ours["waveform"], gold)}


def check_pwg_gan_grads():
    """Both GAN objectives of the port's updater (the discriminator past
    its warm-up) and their gradients, as ``check_pwg_gan_grads``."""
    from tools.golden.pwg import golden_pwg_gan_grads
    gen_state, gcfg = fixtures.pwg_state()
    disc_state, dcfg = fixtures.pwg_disc_state()
    gen = _loaded(pwg_generator(gcfg), tc.convert_pwg_generator(
        gen_state, layers=gcfg["layers"],
        upsample_scales=gcfg["upsample_scales"]))
    disc = _loaded(tm.PWGDiscriminator(layers=dcfg["layers"],
                                       conv_channels=dcfg["conv_channels"]),
                   tc.convert_pwg_discriminator(disc_state,
                                                layers=dcfg["layers"]))
    rng = np.random.default_rng(2)
    up = int(np.prod(gcfg["upsample_scales"]))
    w = gcfg["aux_context_window"]
    t_frames = 24
    noise = rng.standard_normal((1, t_frames * up, 1)).astype(np.float32)
    mel = rng.standard_normal(
        (1, t_frames + 2 * w, gcfg["aux_channels"])).astype(np.float32)
    wav = rng.standard_normal((1, t_frames * up)).astype(np.float32)
    lambda_adv = 4.0
    ffts, hops, wins = (256, 128), (64, 32), (128, 64)
    stft_kw = dict(fft_sizes=ffts, hop_sizes=hops, win_lengths=wins)

    gen_loss, _ = generator_objective(gen, disc, _f(noise), _f(mel),
                                      _f(wav), lambda_adv=lambda_adv,
                                      disc_on=True, stft_kw=stft_kw)
    gen_loss.backward()
    with torch.no_grad():
        fake = gen(_f(noise), _f(mel), deterministic=False)
    disc_loss, _ = discriminator_objective(disc, _f(wav), fake)
    disc_loss.backward()

    gold_metrics, gold_gen, gold_disc = golden_pwg_gan_grads(
        gen_state, disc_state, noise.transpose(0, 2, 1),
        mel.transpose(0, 2, 1), wav,
        gen_cfg=dict(layers=gcfg["layers"], stacks=gcfg["stacks"],
                     upsample_scales=gcfg["upsample_scales"],
                     aux_context_window=w),
        disc_layers=dcfg["layers"], lambda_adv=lambda_adv, **stft_kw)
    return {
        "gen_loss": abs(gen_loss.item() - gold_metrics["generator_loss"]),
        "disc_loss": abs(disc_loss.item()
                         - gold_metrics["discriminator_loss"]),
        "gen_grads": _grads_diff(gen, tc.convert_pwg_generator(
            gold_gen, layers=gcfg["layers"],
            upsample_scales=gcfg["upsample_scales"])),
        "disc_grads": _grads_diff(disc, tc.convert_pwg_discriminator(
            gold_disc, layers=dcfg["layers"])),
    }


# ----------------------------------------------------------- FastSpeech2

FS2_NO_DROPOUT = dict(
    transformer_enc_dropout_rate=0.0,
    transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0,
    transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0,
    transformer_dec_attn_dropout_rate=0.0, postnet_dropout_rate=0.0,
    duration_predictor_dropout_rate=0.0, energy_predictor_dropout=0.0,
    energy_embed_dropout=0.0, pitch_predictor_dropout=0.0,
    pitch_embed_dropout=0.0)


def fs2_convert(state, cfg):
    return tc.convert_fastspeech2(
        state, elayers=cfg["elayers"], dlayers=cfg["dlayers"],
        aheads=cfg["heads"], postnet_layers=cfg["postnet_layers"],
        predictor_layers=2, pitch_predictor_layers=2,
        energy_predictor_layers=2)


def fs2_model(cfg, **kw):
    return tm.FastSpeech2(
        idim=cfg["vocab"], odim=cfg["odim"], adim=cfg["adim"],
        aheads=cfg["heads"], elayers=1, eunits=cfg["eunits"], dlayers=1,
        dunits=cfg["eunits"], postnet_layers=2, postnet_chans=8,
        postnet_filts=5, duration_predictor_chans=cfg["adim"],
        pitch_predictor_layers=2, pitch_predictor_chans=cfg["adim"],
        energy_predictor_chans=cfg["adim"], **kw)


def fs2_inputs(cfg, seed=0, random_speech=False):
    rng = np.random.default_rng(seed)
    b, t = 2, 8
    text = rng.integers(1, cfg["vocab"], (b, t))
    ilens = np.array([8, 5])
    text[1, 5:] = 0
    dur = rng.integers(1, 5, (b, t))
    dur = dur * (np.arange(t)[None] < ilens[:, None])
    olens = dur.sum(1)
    pitch = rng.standard_normal((b, t, 1)).astype(np.float32)
    energy = rng.standard_normal((b, t, 1)).astype(np.float32)
    shape = (b, int(olens.max()), cfg["odim"])
    speech = (rng.standard_normal(shape).astype(np.float32) if random_speech
              else np.zeros(shape, np.float32))
    return dict(text=text, ilens=ilens, dur=dur, olens=olens, pitch=pitch,
                energy=energy, speech=speech)


def _fs2_call(model, x, deterministic):
    return model(_t(x["text"]), _t(x["ilens"]), _f(x["speech"]),
                 _t(x["olens"]), _t(x["dur"]), _f(x["pitch"]),
                 _f(x["energy"]), deterministic=deterministic)


def port_fastspeech2(flat, cfg):
    model = fs2_model(cfg)
    load_flax_params(model, flat)
    x = fs2_inputs(cfg)
    with torch.no_grad():
        out = _fs2_call(model, x, True)
    return {k: _np(out[k]) for k in ("before_outs", "after_outs", "d_outs",
                                     "p_outs", "e_outs")}


def check_fastspeech2():
    from tools.golden.fastspeech2 import golden_fastspeech2_forward
    state, cfg = fixtures.fastspeech2_state()
    out = port_fastspeech2(tc.checkpoint_arrays(*fs2_convert(state, cfg)),
                           cfg)
    x = fs2_inputs(cfg)
    gold = golden_fastspeech2_forward(state, x["text"], x["ilens"], x["dur"],
                                      x["pitch"], x["energy"],
                                      odim=cfg["odim"], heads=cfg["heads"])
    res = {k: _maxdiff(out[k], gold[k], gold["olens"])
           for k in ("before_outs", "after_outs")}
    res.update({k: _maxdiff(out[k], gold[k], x["ilens"])
                for k in ("d_outs", "p_outs", "e_outs")})
    return res


def check_fastspeech2_grads():
    """The masked FastSpeech2 loss with train-mode BatchNorm, dropout 0."""
    from tools.golden.fastspeech2 import golden_fastspeech2_loss_and_grads
    state, cfg = fixtures.fastspeech2_state()
    model = _loaded(fs2_model(cfg, **FS2_NO_DROPOUT),
                    *fs2_convert(state, cfg))
    x = fs2_inputs(cfg, seed=1, random_speech=True)
    out = _fs2_call(model, x, False)
    loss = tm.fastspeech2_loss(out, {
        "speech": _f(x["speech"]), "text_lengths": _t(x["ilens"]),
        "durations": _t(x["dur"]), "pitch": _f(x["pitch"]),
        "energy": _f(x["energy"])}, True, False)["loss"]
    loss.backward()
    gold_loss, gold_paddle = golden_fastspeech2_loss_and_grads(
        state, x["text"], x["ilens"], x["speech"], x["dur"], x["pitch"],
        x["energy"], odim=cfg["odim"], heads=cfg["heads"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, fs2_convert(gold_paddle, cfg)[0])}


# ------------------------------------------------------------- Tacotron2

def t2_convert(state, cfg):
    return tc.convert_tacotron2(
        state, encoder_conv_layers=cfg["encoder_conv_layers"],
        postnet_conv_layers=cfg["postnet_conv_layers"], use_stop_token=True)


def t2_model(cfg):
    return tm.Tacotron2(
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


def t2_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, t_text, t_mel = 2, 5, 8
    text = rng.integers(1, cfg["vocab"], (b, t_text))
    mels = rng.standard_normal((b, t_mel, cfg["d_mels"])).astype(np.float32)
    return dict(text=text, mels=mels, ilens=np.full((b,), t_text),
                olens=np.full((b,), t_mel))


def _t2_call(model, x, deterministic):
    return model(_t(x["text"]), _t(x["ilens"]), _f(x["mels"]),
                 _t(x["olens"]), deterministic=deterministic)


def port_tacotron2(flat, cfg):
    model = t2_model(cfg)
    load_flax_params(model, flat)
    x = t2_inputs(cfg)
    with torch.no_grad():
        out = _t2_call(model, x, True)
    res = {k: _np(out[k]) for k in ("mel_output", "mel_outputs_postnet",
                                    "alignments")}
    res["stop_logits"] = _np(out["stop_logits"]).reshape(2, -1)
    return res


def check_tacotron2():
    from tools.golden.tacotron2 import golden_tacotron2_forward
    state, cfg = fixtures.tacotron2_state()
    out = port_tacotron2(tc.checkpoint_arrays(*t2_convert(state, cfg)), cfg)
    x = t2_inputs(cfg)
    gold = golden_tacotron2_forward(state, x["text"], x["mels"])
    gold["stop_logits"] = gold["stop_logits"].reshape(2, -1)
    return {k: _maxdiff(out[k], gold[k]) for k in out}


def check_tacotron2_grads():
    from tools.golden.tacotron2 import golden_tacotron2_loss_and_grads
    state, cfg = fixtures.tacotron2_state()
    model = _loaded(t2_model(cfg), *t2_convert(state, cfg))
    x = t2_inputs(cfg, seed=5)
    out = _t2_call(model, x, False)
    loss = tm.tacotron2_loss(out, _f(x["mels"]), _t(x["olens"]),
                             _t(x["ilens"]), use_stop_token_loss=True,
                             use_guided_attention_loss=True)["loss"]
    loss.backward()
    gold_loss, gold_paddle = golden_tacotron2_loss_and_grads(
        state, x["text"], x["mels"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, t2_convert(gold_paddle, cfg)[0])}


# ---------------------------------------------------------- SpeedySpeech

def ss_convert(state, cfg):
    return tc.convert_speedyspeech(state, encoder_dilations=cfg["enc_dil"],
                                   decoder_dilations=cfg["dec_dil"])


def ss_model(cfg):
    return tm.SpeedySpeech(
        vocab_size=cfg["vocab"], encoder_hidden_size=cfg["hidden"],
        encoder_dilations=cfg["enc_dil"],
        duration_predictor_hidden_size=cfg["hidden"],
        decoder_hidden_size=cfg["hidden"], decoder_output_size=cfg["odim"],
        decoder_dilations=cfg["dec_dil"], tone_size=cfg["tones"])


def ss_inputs(cfg, seed=0, equal_totals=False):
    rng = np.random.default_rng(seed)
    b, t = 2, 7
    text = rng.integers(1, cfg["vocab"], (b, t))
    tones = rng.integers(1, cfg["tones"], (b, t))
    durs = rng.integers(1, 3, (b, t))
    if equal_totals:
        durs[:, -1] += durs.sum(1).max() - durs.sum(1)
    tot = int(durs.sum(1).max())
    out = dict(text=text, tones=tones, durs=durs, tot=tot)
    if equal_totals:
        out["feats"] = rng.standard_normal(
            (b, tot, cfg["odim"])).astype(np.float32)
    return out


def _ss_call(model, x, deterministic):
    return model(_t(x["text"]), _t(x["durs"]), _t(x["tones"]),
                 max_frames=x["tot"], deterministic=deterministic)


def port_speedyspeech(flat, cfg):
    model = ss_model(cfg)
    load_flax_params(model, flat)
    with torch.no_grad():
        out = _ss_call(model, ss_inputs(cfg), True)
    return {k: _np(out[k]) for k in ("mel", "log_durations")}


def check_speedyspeech():
    from tools.golden.speedyspeech import golden_speedyspeech_forward
    state, cfg = fixtures.speedyspeech_state()
    out = port_speedyspeech(tc.checkpoint_arrays(*ss_convert(state, cfg)),
                            cfg)
    x = ss_inputs(cfg)
    g_mel, g_logd = golden_speedyspeech_forward(
        state, x["text"], x["tones"], x["durs"],
        encoder_dilations=cfg["enc_dil"], decoder_dilations=cfg["dec_dil"])
    return {"mel": _maxdiff(out["mel"], g_mel, x["durs"].sum(1)),
            "log_durations": _maxdiff(out["log_durations"], g_logd)}


def check_speedyspeech_grads():
    from tools.golden.speedyspeech import golden_speedyspeech_loss_and_grads
    state, cfg = fixtures.speedyspeech_state()
    model = _loaded(ss_model(cfg), *ss_convert(state, cfg))
    x = ss_inputs(cfg, seed=7, equal_totals=True)
    b, t = x["text"].shape
    out = _ss_call(model, x, False)
    loss = tm.speedyspeech_loss(out, {
        "feats": _f(x["feats"]), "num_frames": torch.full((b,), x["tot"]),
        "num_phones": torch.full((b,), t),
        "durations": _t(x["durs"])})["loss"]
    loss.backward()
    gold_loss, gold_paddle = golden_speedyspeech_loss_and_grads(
        state, x["text"], x["tones"], x["durs"], x["feats"],
        encoder_dilations=cfg["enc_dil"], decoder_dilations=cfg["dec_dil"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, ss_convert(gold_paddle, cfg)[0])}


# -------------------------------------------------------------- WaveFlow

def wf_convert(state, cfg):
    return tc.convert_waveflow(state, n_flows=cfg["n_flows"],
                               n_layers=cfg["n_layers"],
                               upsample_factors=cfg["factors"])


def wf_model(cfg):
    return tm.ConditionalWaveFlow(
        upsample_factors=cfg["factors"], n_flows=cfg["n_flows"],
        n_layers=cfg["n_layers"], n_group=cfg["n_group"],
        channels=cfg["channels"], n_mels=cfg["n_mels"])


def wf_inputs(cfg, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((batch, 64)).astype(np.float32)
    mel = rng.standard_normal((batch, 16, cfg["n_mels"])).astype(np.float32)
    return audio, mel


def port_waveflow(flat, cfg):
    model = wf_model(cfg)
    load_flax_params(model, flat)
    audio, mel = wf_inputs(cfg)
    with torch.no_grad():
        z, logdet = model(_f(audio), _f(mel))
    return {"z": _np(z), "log_det": _np(logdet.sum())}


def check_waveflow():
    from tools.golden.waveflow import golden_waveflow_forward
    state, cfg = fixtures.waveflow_state()
    out = port_waveflow(tc.checkpoint_arrays(wf_convert(state, cfg)), cfg)
    audio, mel = wf_inputs(cfg)
    gz, glogdet = golden_waveflow_forward(
        state, audio, mel.transpose(0, 2, 1), n_flows=cfg["n_flows"],
        n_layers=cfg["n_layers"], n_group=cfg["n_group"],
        upsample_factors=cfg["factors"])
    return {"z": _maxdiff(out["z"], gz),
            "log_det": _maxdiff(out["log_det"], glogdet)}


def check_waveflow_grads():
    from tools.golden.waveflow import golden_waveflow_loss_and_grads
    state, cfg = fixtures.waveflow_state()
    model = _loaded(wf_model(cfg), wf_convert(state, cfg))
    audio, mel = wf_inputs(cfg, seed=3, batch=2)
    loss = tm.waveflow_loss(*model(_f(audio), _f(mel)))["loss"]
    loss.backward()
    gold_loss, gold_paddle = golden_waveflow_loss_and_grads(
        state, audio, mel.transpose(0, 2, 1), n_flows=cfg["n_flows"],
        n_layers=cfg["n_layers"], n_group=cfg["n_group"],
        upsample_factors=cfg["factors"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, wf_convert(gold_paddle, cfg))}


# -------------------------------------------------------- TransformerTTS

def tt_convert(state, cfg):
    return tc.convert_transformer_tts(state, elayers=1, dlayers=1,
                                      aheads=cfg["heads"], dprenet_layers=2,
                                      postnet_layers=2)


def tt_model(cfg, **kw):
    return tm.TransformerTTS(
        idim=cfg["idim"], odim=cfg["odim"], adim=cfg["adim"],
        aheads=cfg["heads"], elayers=1, eunits=cfg["units"], dlayers=1,
        dunits=cfg["units"], eprenet_conv_layers=0,
        dprenet_units=cfg["dp_units"], postnet_layers=2, postnet_chans=8,
        postnet_filts=3, reduction_factor=1, dprenet_dropout_rate=0.0, **kw)


def tt_inputs(cfg, seed=0, olens=(8, 6)):
    rng = np.random.default_rng(seed)
    b = 2
    text = rng.integers(1, cfg["idim"] - 1, (b, 6))
    text[1, 4:] = 0
    mels = rng.standard_normal((b, 8, cfg["odim"])).astype(np.float32)
    return dict(text=text, tl=np.array([6, 4]), mels=mels,
                ol=np.array(olens))


def _tt_call(model, x, deterministic):
    return model(_t(x["text"]), _t(x["tl"]), _f(x["mels"]), _t(x["ol"]),
                 deterministic=deterministic)


def port_transformer_tts(flat, cfg):
    model = tt_model(cfg)
    load_flax_params(model, flat)
    with torch.no_grad():
        out = _tt_call(model, tt_inputs(cfg), True)
    return {k: _np(out[k]) for k in ("before_outs", "after_outs",
                                     "stop_logits")}


def check_transformer_tts():
    from tools.golden.transformer_tts import golden_transformer_tts_forward
    state, cfg = fixtures.transformer_tts_state()
    out = port_transformer_tts(
        tc.checkpoint_arrays(*tt_convert(state, cfg)), cfg)
    x = tt_inputs(cfg)
    gold = golden_transformer_tts_forward(
        state, x["text"], x["tl"], x["mels"], x["ol"], odim=cfg["odim"],
        eos=cfg["idim"] - 1, heads=cfg["heads"])
    return {k: _maxdiff(out[k], gold[k], x["ol"]) for k in out}


def check_transformer_tts_grads():
    from tools.golden.transformer_tts import (
        golden_transformer_tts_loss_and_grads)
    state, cfg = fixtures.transformer_tts_state()
    model = _loaded(tt_model(
        cfg, transformer_enc_dropout_rate=0.0,
        transformer_enc_positional_dropout_rate=0.0,
        transformer_enc_attn_dropout_rate=0.0,
        transformer_dec_dropout_rate=0.0,
        transformer_dec_positional_dropout_rate=0.0,
        transformer_dec_attn_dropout_rate=0.0,
        transformer_enc_dec_attn_dropout_rate=0.0,
        postnet_dropout_rate=0.0), *tt_convert(state, cfg))
    x = tt_inputs(cfg, seed=6, olens=(8, 8))
    out = _tt_call(model, x, False)
    loss = tm.transformer_tts_loss(out, _f(x["mels"]), _t(x["ol"]))["loss"]
    loss.backward()
    gold_loss, gold_paddle = golden_transformer_tts_loss_and_grads(
        state, x["text"], x["tl"], x["mels"], x["ol"], odim=cfg["odim"],
        eos=cfg["idim"] - 1, heads=cfg["heads"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, tt_convert(gold_paddle, cfg)[0])}


# ------------------------------------------------------------------ GE2E

def ge2e_model(cfg):
    return tm.LSTMSpeakerEncoder(n_mels=cfg["n_mels"],
                                 num_layers=cfg["num_layers"],
                                 hidden_size=cfg["hidden_size"],
                                 output_size=cfg["output_size"])


def ge2e_inputs(cfg, seed=0):
    n, m, t = 4, 5, 16
    utts = np.random.default_rng(seed).standard_normal(
        (n * m, t, cfg["n_mels"])).astype(np.float32)
    return utts, n


def _ge2e_call(model, utts, n):
    embeds, (w, b) = model.embed_sequences(_f(utts), n)
    loss, aux = tm.ge2e_loss(embeds, w, b)
    return embeds, aux["sim"], loss


def port_ge2e(flat, cfg):
    model = ge2e_model(cfg)
    load_flax_params(model, flat)
    utts, n = ge2e_inputs(cfg)
    with torch.no_grad():
        embeds, sim, loss = _ge2e_call(model, utts, n)
    return {"embeds": _np(embeds).reshape(len(utts), -1),
            "sim": _np(sim).reshape(len(utts), n),
            "loss": _np(loss).reshape(1)}


def check_ge2e():
    from tools.golden.ge2e import golden_ge2e_forward
    state, cfg = fixtures.ge2e_state()
    out = port_ge2e(tc.checkpoint_arrays(tc.convert_ge2e(
        state, num_layers=cfg["num_layers"])), cfg)
    utts, n = ge2e_inputs(cfg)
    gold = golden_ge2e_forward(state, utts, n, num_layers=cfg["num_layers"])
    return {k: _maxdiff(out[k], gold[k]) for k in out}


def check_ge2e_grads():
    """Including the reference's x0.01 scaling of the (w, b) gradients."""
    from tools.golden.ge2e import golden_ge2e_loss_and_grads
    state, cfg = fixtures.ge2e_state()
    model = _loaded(ge2e_model(cfg),
                    tc.convert_ge2e(state, num_layers=cfg["num_layers"]))
    utts, n = ge2e_inputs(cfg, seed=4)
    _, _, loss = _ge2e_call(model, utts, n)
    loss.backward()
    tm.scale_wb_gradients(model)
    gold_loss, gold_paddle = golden_ge2e_loss_and_grads(
        state, utts, n, num_layers=cfg["num_layers"])
    return {"loss": abs(loss.item() - gold_loss),
            "grads": _grads_diff(model, tc.convert_ge2e(
                gold_paddle, num_layers=cfg["num_layers"]))}


CHECKS = {
    "fastspeech2": check_fastspeech2,
    "fastspeech2_grads": check_fastspeech2_grads,
    "parallel_wavegan": check_pwg,
    "pwg_gan_grads": check_pwg_gan_grads,
    "tacotron2": check_tacotron2,
    "tacotron2_grads": check_tacotron2_grads,
    "transformer_tts": check_transformer_tts,
    "transformer_tts_grads": check_transformer_tts_grads,
    "speedyspeech": check_speedyspeech,
    "speedyspeech_grads": check_speedyspeech_grads,
    "waveflow": check_waveflow,
    "waveflow_grads": check_waveflow_grads,
    "ge2e": check_ge2e,
    "ge2e_grads": check_ge2e_grads,
}


def test_checks_cover_run_parity():
    """The same 14 families as ``tools/golden/run_parity.py::CHECKS``."""
    import ast
    src = (Path(__file__).resolve().parent.parent / "tools" / "golden"
           / "run_parity.py").read_text()
    tree = ast.parse(src)
    keys = next(node.value.keys for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "CHECKS")
    assert sorted(k.value for k in keys) == sorted(CHECKS)


@pytest.mark.parametrize("family", sorted(CHECKS))
def test_port_matches_golden_oracle(family):
    for output, maxdiff in CHECKS[family]().items():
        assert maxdiff < TOL, (
            f"{family}.{output}: max abs diff {maxdiff:.3e} against the "
            f"float64 golden oracle (tolerance {TOL})")
