"""flax's mixed precision in the port: each family built with
``dtype=torch.bfloat16`` (float32 parameters, bf16 products at the JAX
modules' cast points) against the JAX package at ``dtype=jnp.bfloat16``
on the same float32 weights.

The JAX side runs without XLA's excess precision (``_exact``), so each
bf16 result is rounded where the program says, as the port rounds it op
by op.  Weights are drawn with numpy and loaded into both packages;
inputs are made with numpy from a seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from parakeet_tpu.models import ConditionalWaveFlow as JWF
from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import LSTMSpeakerEncoder as JGE2E
from parakeet_tpu.models import PWGGenerator as JPWG
from parakeet_tpu.models import SpeedySpeech as JSS
from parakeet_tpu.models import Tacotron2 as JT2
from parakeet_tpu.models import TransformerTTS as JTTS
from parakeet_tpu.models.fs2_updater import make_fs2_train_step as j_fs2_step
from parakeet_tpu.models.ge2e_updater import \
    make_ge2e_train_step as j_ge2e_step
from parakeet_tpu.models.speedyspeech_updater import \
    make_speedyspeech_train_step as j_ss_step
from parakeet_tpu.models.tacotron2_updater import \
    make_tacotron2_train_step as j_t2_step
from parakeet_tpu.models.transformer_tts_updater import \
    make_transformer_tts_train_step as j_tts_step
from parakeet_tpu.models.waveflow_updater import \
    make_waveflow_train_step as j_wf_step
from parakeet_tpu.nn.style_encoder import StyleEncoder as JGST
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.state import TrainState as JTrainState
from parakeet_tpu_torch import models as tmodels
from parakeet_tpu_torch.bridge import (_flax_leaves, flax_arrays, flax_grads,
                                       load_flax_params, load_train_state)
from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
from parakeet_tpu_torch.models.parallel_wavegan import pwg_inference
from parakeet_tpu_torch.nn.precision import cast_once
from parakeet_tpu_torch.nn.style_encoder import StyleEncoder
from parakeet_tpu_torch.recipes.ge2e import train as ge2e_train
from parakeet_tpu_torch.recipes.ge2e.dump import write_synthetic_mels
from parakeet_tpu_torch.training import build_optimizer, resolve_model_kwargs
from parakeet_tpu_torch.utils.flops import _BMM_DTYPE

import test_torch_family_recipes as fam_recipes
import test_torch_fs2_recipe as fs2_recipe
from test_torch_slice import FS2, HOP, MAX_FRAMES, PWG, _batch, _randomize
from test_torch_transformer_tts import _flax_tree

torch.set_num_threads(1)

BF16 = torch.bfloat16
# the serving slice: the largest error as a share of the output's range.
# The two packages' bf16 programs round at the same points: the mels are
# bit for bit JAX's (measured 0); the waveforms differ where the fused
# stacks' float32 sums, in other orders, flip a bf16 rounding (measured
# 1.7e-3; one bf16 ulp of the range is 2^-8, as in test_torch_slice.py).
# A program that rounds the parameters instead (``module.to(bfloat16)``)
# misses both by far: mel 2.5e-2, waveform 1.0e-1.
SLICE_MEL_TOL = 1e-3
SLICE_WAV_TOL = 2 ** -8


def _exact(fn, *args):
    """``fn`` jitted without XLA's excess precision: each bf16 result is
    rounded where the program says (by default XLA may drop a float32 ->
    bf16 -> float32 pair of converts)."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    return fn.lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)


def _range_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# ------------------------------------------------------ the serving slice

@pytest.fixture(scope="module")
def slice_weights():
    """float32 FastSpeech2 and PWG weights (flat flax trees) at the slice
    test's widths."""
    v = jax.jit(lambda k: JFS2(**FS2).init(
        {"params": k}, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
        max_frames=MAX_FRAMES, spk_id=jnp.asarray([0]),
        method=JFS2.inference))(jax.random.PRNGKey(0))
    pv = jax.jit(JPWG(stack_impl="xla", **PWG).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16 * HOP, 1)),
        jnp.zeros((1, 18, 10)))
    return _randomize(flatten_tree(v), 0), _randomize(flatten_tree(pv), 1)


def _jax_slice(flat, pflat, text, lengths, spk, noise):
    """JAX's bf16 slice: (durations, mel, waveform)."""
    jfs2 = JFS2(dtype=jnp.bfloat16, **FS2)
    jpwg = JPWG(stack_impl="pallas", dtype=jnp.bfloat16, **PWG)
    v, pv = nest_flat(flat), nest_flat(pflat)

    def run(t, n, s, z):
        out = jfs2.apply(v, t, n, max_frames=MAX_FRAMES, spk_id=s,
                         min_duration=1, method=JFS2.inference)
        mel = out["after_outs"]
        wav = jpwg.apply(pv, z, jnp.pad(mel, ((0, 0), (1, 1), (0, 0)),
                                        mode="edge"))
        return out["d_outs"], mel, wav[..., 0]

    return [np.asarray(a, np.float32) for a in _exact(
        run, *map(jnp.asarray, (text, lengths, spk, noise)))]


def _port_slice(fs2, pwg, text, lengths, spk, noise, durations):
    with torch.no_grad():
        out = fs2.inference(*map(torch.from_numpy, (text, lengths)),
                            max_frames=MAX_FRAMES,
                            spk_id=torch.from_numpy(spk), min_duration=1,
                            durations=torch.from_numpy(durations))
        wav = pwg_inference(pwg, out["after_outs"],
                            noise=torch.from_numpy(noise))
    return out["after_outs"].float().numpy(), wav.float().numpy()


def _slice_models(flat, pflat, cast_parameters=False):
    """The port's bf16 slice: flax's ``dtype=`` on float32 parameters, or
    with ``cast_parameters`` the parameters rounded to bf16."""
    dtype = None if cast_parameters else BF16
    fs2 = FastSpeech2(dtype=dtype, **FS2)
    pwg = PWGGenerator(stack_impl="fused", dtype=dtype, **PWG)
    load_flax_params(fs2, flat)
    load_flax_params(pwg, pflat)
    if cast_parameters:
        fs2, pwg = fs2.to(BF16), pwg.to(BF16)
    return fs2.eval(), pwg.eval()


def _slice_errors(slice_weights, cast_parameters=False):
    flat, pflat = slice_weights
    text, lengths, spk = _batch()
    noise = np.random.default_rng(6).standard_normal(
        (3, MAX_FRAMES * HOP, 1)).astype(np.float32)
    ds, want_mel, want_wav = _jax_slice(flat, pflat, text, lengths, spk,
                                        noise)
    fs2, pwg = _slice_models(flat, pflat, cast_parameters)
    # the JAX durations go into both, so a flip cannot shift frames
    got_mel, got_wav = _port_slice(fs2, pwg, text, lengths, spk, noise, ds)
    assert got_wav.shape == want_wav.shape == (3, MAX_FRAMES * HOP)
    assert np.isfinite(got_wav).all()
    return _range_err(got_mel, want_mel), _range_err(got_wav, want_wav)


def test_bf16_slice_matches_jax_bf16(slice_weights):
    """FastSpeech2.inference -> edge pad -> PWGGenerator, both at
    ``dtype=bfloat16`` on float32 parameters, against the JAX package's
    bf16 slice (its Pallas stack in interpret mode, the port's K1 plain
    version)."""
    mel_err, wav_err = _slice_errors(slice_weights)
    assert mel_err <= SLICE_MEL_TOL, mel_err
    assert wav_err <= SLICE_WAV_TOL, wav_err


def test_cast_parameter_slice_is_another_function(slice_weights):
    """The build the bf16 programs had before, every parameter rounded to
    bf16 (``module.to(torch.bfloat16)``), misses JAX's bf16 slice by far
    more than the tolerances above."""
    mel_err, wav_err = _slice_errors(slice_weights, cast_parameters=True)
    assert mel_err > 10 * SLICE_MEL_TOL and wav_err > 10 * SLICE_WAV_TOL, (
        mel_err, wav_err)


def test_bf16_slice_with_weights_rounded_once_is_the_same_function(
        slice_weights):
    """A captured program rounds its weights to bf16 in its warm-up runs
    and its graph reuses those copies (``cast_once`` with a kept dict,
    ``utils/graphs.py``): run so, the slice is bit for bit the eager
    slice, and the second run rounds no parameter of its own."""
    flat, pflat = slice_weights
    text, lengths, spk = _batch()
    noise = np.random.default_rng(6).standard_normal(
        (3, MAX_FRAMES * HOP, 1)).astype(np.float32)
    durations = np.full(text.shape, 2, np.int32)
    fs2, pwg = _slice_models(flat, pflat)
    args = (fs2, pwg, text, lengths, spk, noise, durations)
    want = _port_slice(*args)
    casts = {}
    with cast_once(casts):
        warm = _port_slice(*args)
    made = dict(casts)
    assert made and all(t.dtype == BF16 for t in made.values())
    with cast_once(casts):
        got = _port_slice(*args)
    assert casts.keys() == made.keys()
    assert all(casts[k] is made[k] for k in made)
    for a, b, c in zip(want, warm, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("frames", [20, 31])
def test_bf16_gst_matches_jax_bf16(frames):
    """GST at ``dtype=bfloat16`` (bf16 convolutions, BatchNorm in float32,
    the GRU as flax's scan: bf16 gates, a float32 carry; the token
    attention) against the JAX module's, bit for bit."""
    rng = np.random.default_rng(frames)
    speech = rng.standard_normal((2, frames, 8)).astype(np.float32)
    kw = dict(gst_tokens=3, gst_token_dim=16, gst_heads=2, conv_layers=3,
              conv_chans_list=(4, 6, 6), gru_units=6)
    flat = _flax_tree(JGST(**kw), 5, jnp.asarray(speech))
    jg = JGST(dtype=jnp.bfloat16, **kw)
    want = _exact(lambda v, x: jg.apply(v, x), nest_flat(flat),
                  jnp.asarray(speech))
    tg = StyleEncoder(8, dtype=BF16, **kw)
    load_flax_params(tg, flat)
    with torch.no_grad():
        got = tg(torch.from_numpy(speech))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# --------------------------------------------- the six families' train steps

LR = 1e-3
METRIC_REL = 2 ** -7          # each metric, relative
GRAD_REL_L2 = 2 ** -5         # all gradients, relative L2 (as the PWG step)
# a bf16 forward at inference (BatchNorm on its running statistics): the
# largest error as a share of the output's range.  Measured: FastSpeech2,
# SpeedySpeech, Tacotron2, TransformerTTS and GE2E 0 (bit for bit);
# WaveFlow 4.5e-8, a float32 rounding of its float32 z (its bf16 (logs, b)
# bit for bit).
FORWARD_TOL = {"waveflow": 2 ** -20}
# the families at ``tests/test_models_train.py::test_train_step_bf16``'s
# widths; every dropout rate 0 (both packages draw their own masks), the
# second utterance padded
NO_DROPOUT = {
    "fastspeech2": dict.fromkeys((
        "duration_predictor_dropout_rate", "energy_predictor_dropout",
        "energy_embed_dropout", "pitch_predictor_dropout",
        "pitch_embed_dropout", "transformer_enc_dropout_rate",
        "transformer_enc_positional_dropout_rate",
        "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
        "transformer_dec_positional_dropout_rate",
        "transformer_dec_attn_dropout_rate", "postnet_dropout_rate"), 0.0),
    "tacotron2": dict.fromkeys((
        "p_encoder_dropout", "p_prenet_dropout", "p_attention_dropout",
        "p_decoder_dropout", "p_postnet_dropout"), 0.0),
    "transformer_tts": dict.fromkeys((
        "transformer_enc_dropout_rate",
        "transformer_enc_positional_dropout_rate",
        "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
        "transformer_dec_positional_dropout_rate",
        "transformer_dec_attn_dropout_rate",
        "transformer_enc_dec_attn_dropout_rate", "eprenet_dropout_rate",
        "dprenet_dropout_rate", "postnet_dropout_rate"), 0.0),
}
CONFIGS = {
    "fastspeech2": dict(idim=11, odim=6, adim=16, aheads=2, elayers=1,
                        eunits=24, dlayers=1, dunits=24, postnet_layers=1,
                        postnet_chans=8, postnet_filts=3,
                        duration_predictor_chans=8, pitch_predictor_chans=8,
                        energy_predictor_chans=8),
    "speedyspeech": dict(vocab_size=11, encoder_hidden_size=8,
                         encoder_kernel_size=3, encoder_dilations=(1,),
                         decoder_hidden_size=8, decoder_kernel_size=3,
                         decoder_dilations=(1,), decoder_output_size=6,
                         duration_predictor_hidden_size=8),
    "tacotron2": dict(vocab_size=11, d_mels=6, d_encoder=8,
                      encoder_conv_layers=1, encoder_kernel_size=3,
                      d_prenet=4, d_attention_rnn=8, d_decoder_rnn=8,
                      d_attention=8, attention_filters=4,
                      attention_kernel_size=5, d_postnet=4,
                      postnet_kernel_size=3, postnet_conv_layers=2),
    "transformer_tts": dict(idim=11, odim=6, adim=16, aheads=2, elayers=1,
                            eunits=24, dlayers=1, dunits=24,
                            eprenet_conv_layers=0, dprenet_units=8,
                            postnet_layers=2, postnet_chans=8,
                            postnet_filts=3),
    "waveflow": dict(upsample_factors=(4, 5), n_flows=2, n_layers=2,
                     n_group=4, channels=8, n_mels=6),
    "ge2e": dict(n_mels=6, num_layers=1, hidden_size=8, output_size=4),
}
FAMILIES = tuple(CONFIGS)
GE2E_SPEAKERS = 4
# the leaves a flax module creates in its ``dtype``: GE2E's scale (w, b)
BF16_LEAVES = {"params::similarity_weight", "params::similarity_bias"}


def _family_batch(family: str) -> dict:
    rng = np.random.default_rng(7)
    if family == "waveflow":
        return {"wav": (0.3 * rng.standard_normal((2, 8 * 20))).astype(
                    np.float32),
                "mel": rng.standard_normal((2, 8, 6)).astype(np.float32)}
    if family == "ge2e":
        return {"utterances": rng.standard_normal(
            (GE2E_SPEAKERS * 3, 10, 6)).astype(np.float32)}
    text = rng.integers(1, 11, (2, 5))
    text[1, 4] = 0                                  # padding
    speech = rng.standard_normal((2, 8, 6)).astype(np.float32)
    if family == "speedyspeech":
        return {"phones": text, "num_phones": np.array([5, 4]),
                "feats": speech, "num_frames": np.array([8, 7]),
                "durations": np.array([[2, 2, 2, 1, 1], [2, 2, 2, 1, 0]])}
    batch = {"text": text, "text_lengths": np.array([5, 4]),
             "speech": speech, "speech_lengths": np.array([8, 7])}
    if family == "fastspeech2":
        batch.update(
            durations=np.array([[2, 2, 2, 1, 1], [2, 2, 2, 1, 0]]),
            pitch=rng.standard_normal((2, 5, 1)).astype(np.float32),
            energy=rng.standard_normal((2, 5, 1)).astype(np.float32))
    return batch


def _jax_model(family: str, dtype=jnp.bfloat16):
    kw = {**CONFIGS[family], **NO_DROPOUT.get(family, {}), "dtype": dtype}
    return {"fastspeech2": JFS2, "speedyspeech": JSS, "tacotron2": JT2,
            "transformer_tts": JTTS, "waveflow": JWF,
            "ge2e": JGE2E}[family](**kw)


def _port_model(family: str, dtype=BF16):
    kw = {**CONFIGS[family], **NO_DROPOUT.get(family, {}), "dtype": dtype}
    cls = {"fastspeech2": tmodels.FastSpeech2,
           "speedyspeech": tmodels.SpeedySpeech,
           "tacotron2": tmodels.Tacotron2,
           "transformer_tts": tmodels.TransformerTTS,
           "waveflow": tmodels.ConditionalWaveFlow,
           "ge2e": tmodels.LSTMSpeakerEncoder}[family]
    return cls(**kw)


def _jax_apply(family, jm, variables, jbatch, *, train):
    """The model's forward (train: as its step runs it, on batch
    statistics), returning its main output."""
    kw = dict(mutable=["batch_stats"]) if train else {}
    b = jbatch
    if family == "fastspeech2":
        out = jm.apply(variables, b["text"], b["text_lengths"], b["speech"],
                       b["speech_lengths"], b["durations"], b["pitch"],
                       b["energy"], deterministic=not train, **kw)
        key = "after_outs"
    elif family == "speedyspeech":
        out = jm.apply(variables, b["phones"], b["durations"],
                       max_frames=b["feats"].shape[1],
                       deterministic=not train, **kw)
        key = "mel"
    elif family in ("tacotron2", "transformer_tts"):
        out = jm.apply(variables, b["text"], b["text_lengths"], b["speech"],
                       b["speech_lengths"], deterministic=not train, **kw)
        key = ("mel_outputs_postnet" if family == "tacotron2"
               else "after_outs")
    elif family == "waveflow":
        return jm.apply(variables, b["wav"], b["mel"])[0]
    else:
        return jm.apply(variables, b["utterances"])
    return (out[0] if train else out)[key]


def _port_apply(family, tm, tb):
    """The port's forward at inference, its main output."""
    with torch.no_grad():
        if family == "fastspeech2":
            return tm(tb["text"], tb["text_lengths"], tb["speech"],
                      tb["speech_lengths"], tb["durations"], tb["pitch"],
                      tb["energy"], deterministic=True)["after_outs"]
        if family == "speedyspeech":
            return tm(tb["phones"], tb["durations"],
                      max_frames=tb["feats"].shape[1])["mel"]
        if family in ("tacotron2", "transformer_tts"):
            out = tm(tb["text"], tb["text_lengths"], tb["speech"],
                     tb["speech_lengths"])
            return out["mel_outputs_postnet" if family == "tacotron2"
                       else "after_outs"]
        if family == "waveflow":
            return tm(tb["wav"], tb["mel"])[0]
        return tm(tb["utterances"])


def _family_pair(family: str):
    """(JAX bf16 model, its variables, port bf16 model with the same
    weights, the flat tree, the batch): float32 parameters drawn with
    numpy (GE2E's scale (3, -1), in bf16 as the JAX module makes it)."""
    batch = _family_batch(family)
    jm = _jax_model(family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def init(k):
        if family == "ge2e":
            return jm.init(k, jb["utterances"])
        if family == "waveflow":
            return jm.init(k, jb["wav"], jb["mel"])
        return jm.init({"params": k, "dropout": k}, *[
            jb[n] for n in {
                "fastspeech2": ("text", "text_lengths", "speech",
                                "speech_lengths", "durations", "pitch",
                                "energy"),
                "speedyspeech": ("phones", "durations"),
            }.get(family, ("text", "text_lengths", "speech",
                           "speech_lengths"))],
            **({"max_frames": 8} if family == "speedyspeech" else {}),
            deterministic=False)

    shapes = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(init, jax.random.PRNGKey(0))))
    flat = {}
    scale = {"params::similarity_weight": 3.0,
             "params::similarity_bias": -1.0}
    for key, leaf in _randomize({k: np.zeros(a.shape, np.float32)
                                 for k, a in shapes.items()
                                 if k not in scale}, 3).items():
        flat[key] = leaf
    for key in scale:
        if key in shapes:
            flat[key] = np.asarray(scale[key], shapes[key].dtype)
    tm = _port_model(family)
    load_flax_params(tm, flat)
    return jm, nest_flat(flat), tm, flat, batch


def _recording(tx):
    """``tx`` that also keeps the gradients of its last update in its
    state: the gradients a JAX train step hands its optimizer (GE2E's
    after the (w, b) scaling)."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_step(family, jm, variables, jbatch):
    """One Adam step (lr 1e-3) of the JAX updater at bf16: (metrics, the
    gradients it applied)."""
    tx = _recording(jbuild("adam", LR))
    params = variables["params"]
    if family == "ge2e":
        step = j_ge2e_step(jm, tx, GE2E_SPEAKERS, jit=False)
    elif family == "transformer_tts":
        step = j_tts_step(jm, tx, use_guided_attn_loss=False, jit=False)
    else:
        step = {"fastspeech2": j_fs2_step, "speedyspeech": j_ss_step,
                "tacotron2": j_t2_step, "waveflow": j_wf_step}[family](
                    jm, tx, jit=False)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params),
                        batch_stats=variables.get("batch_stats"),
                        rng=jax.random.PRNGKey(0))
    new_state, metrics = _exact(step, state, jbatch)
    return metrics, new_state.opt_state[1]


def _port_step(family, tm, tb):
    """One Adam step (lr 1e-3) of the port's updater: (metrics, the
    optimizer)."""
    opt = build_optimizer(tm.parameters(), "adam", LR)
    gen = torch.Generator().manual_seed(0)
    if family == "ge2e":
        state = tmodels.init_ge2e_train_state(tm, opt)
        step = tmodels.make_ge2e_train_step(tm, opt, GE2E_SPEAKERS)
    elif family == "transformer_tts":
        state = tmodels.init_transformer_tts_train_state(tm, opt, gen)
        step = tmodels.make_transformer_tts_train_step(
            tm, opt, use_guided_attn_loss=False)
    else:
        name = {"fastspeech2": "fs2"}.get(family, family)
        state = getattr(tmodels, f"init_{name}_train_state")(tm, opt, gen)
        step = getattr(tmodels, f"make_{name}_train_step")(tm, opt)
    state, metrics = step(state, tb)
    assert state.step == 1
    return metrics, opt


def _flat_l2(tree: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k], np.float64).ravel()
                           for k in keys])


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_forward_matches_jax_bf16(family):
    """Each family's bf16 forward at inference (BatchNorm on its running
    statistics) against the JAX module's at ``dtype=bfloat16``, on the
    same float32 weights, within ``FORWARD_TOL`` of the output's range
    (bit for bit where it names no tolerance);
    the port's output is in the compute dtype where JAX's is (WaveFlow's
    z, float32, aside)."""
    jm, variables, tm, _, batch = _family_pair(family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = _exact(lambda v, b: _jax_apply(family, jm, v, b, train=False),
                  variables, jb)
    got = _port_apply(family, tm.eval(), {k: torch.from_numpy(np.asarray(v))
                                          for k, v in batch.items()})
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    err = _range_err(got.float().numpy(), np.asarray(want, np.float32))
    assert err <= FORWARD_TOL.get(family, 0.0), err


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_train_step_matches_jax_bf16(family):
    """One bf16 Adam step of each family's updater against the JAX
    updater's at ``dtype=bfloat16`` (``test_train_step_bf16``'s widths,
    dropout 0): every metric within 2^-7 relative, all gradients within
    2^-5 relative L2 (the PWG GAN step's bound); parameters, gradients and
    Adam's moments float32, but GE2E's scale (w, b), which the JAX module
    creates in bf16, in bf16 as there."""
    jm, variables, tm, flat, batch = _family_pair(family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = _jax_step(family, jm, variables, jb)
    got, opt = _port_step(family, tm, {k: torch.from_numpy(np.asarray(v))
                                       for k, v in batch.items()})
    for name, value in want.items():
        value = float(value)
        assert np.isfinite(value), name
        assert abs(float(got[name]) - value) <= METRIC_REL * abs(value), (
            name, float(got[name]), value)
    want_g = flatten_tree({"params": jgrads})
    got_g = flax_grads(tm)
    assert sorted(got_g) == sorted(want_g)
    keys = sorted(want_g)
    g, w = _flat_l2(got_g, keys), _flat_l2(want_g, keys)
    assert np.linalg.norm(g - w) <= GRAD_REL_L2 * np.linalg.norm(w)
    for key, _, t, _ in _flax_leaves(tm):
        dtype = BF16 if key in BF16_LEAVES else torch.float32
        assert t.dtype == dtype, key
        if t.requires_grad:
            assert t.grad.dtype == dtype, key
            st = opt.inner.state[t]
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == dtype
    assert {str(np.asarray(want_g[k]).dtype) for k in BF16_LEAVES
            if k in want_g} <= {"bfloat16"}
    assert (family == "ge2e") == bool(BF16_LEAVES & set(flat))


# ------------------------------------------- the recipes and the bridge


def _trained_model(trainer):
    (model,) = trainer.updater.train_state.modules.values()
    return model


@pytest.mark.parametrize("family", ["fastspeech2", "speedyspeech",
                                    "tacotron2", "transformer_tts",
                                    "waveflow", "ge2e"])
def test_recipe_trains_in_bf16_on_the_cpu(tmp_path, family):
    """Each family's train.py with ``--opts model.dtype bfloat16`` (GE2E's
    ``--dtype bfloat16``) at tiny widths: the steps run, every metric is
    finite, and the model computes in bf16 on float32 parameters (GE2E's
    scale in bf16, as the JAX module makes it)."""
    bf16 = ["model.dtype", "bfloat16"]
    if family == "ge2e":
        root = write_synthetic_mels(tmp_path / "mels", seed=1, speakers=3,
                                    utterances=3, frames=(15, 40), n_mels=8)
        state, metrics = ge2e_train.main([
            "--data-root", str(root), "--output-dir", str(tmp_path / "exp"),
            "--speakers-per-batch", "2", "--utterances-per-speaker", "2",
            "--frames", "20", "--n-mels", "8", "--max-iteration", "2",
            "--save-interval", "2", "--device", "cpu", "--dtype",
            "bfloat16"])
        (model,) = state.modules.values()
        assert state.step == 2 and metrics["loss"].dtype == BF16
        observed = metrics
    elif family == "fastspeech2":
        trainer = fs2_recipe._run(fs2_recipe._dump(tmp_path),
                                  tmp_path / "exp", 1, opts=bf16)
        model, observed = _trained_model(trainer), trainer.observation
    elif family == "waveflow":
        md = fam_recipes.wf_dump(tmp_path / "dump", seed=3,
                                 splits={"train": 4, "dev": 2},
                                 frames=(5, 12), n_mels=8, n_shift=16)
        trainer = fam_recipes.wf_train.main([
            "--config", "recipes/waveflow/conf/default.yaml",
            "--train-metadata", str(md["train"]), "--dev-metadata",
            str(md["dev"]), "--output-dir", str(tmp_path / "exp"),
            "--device", "cpu", "--opts", *fam_recipes.WF_OPTS, *bf16,
            "max_iteration", "2"])
        model, observed = _trained_model(trainer), trainer.observation
    else:
        dump = {"speedyspeech": fam_recipes.ss_dump,
                "tacotron2": fam_recipes.t2_dump,
                "transformer_tts": fam_recipes.tt_dump}[family]
        kw = dict(n_mels=8, frames=(10, 20), phones=(4, 9))
        if family == "speedyspeech":
            kw.update(frames=(30, 60), phones=(6, 12))
        md = dump(tmp_path / "dump", seed=3, splits={"train": 8, "dev": 3},
                  **kw)
        argv = ["--config", f"recipes/{family}/conf/default.yaml",
                "--train-metadata", str(md["train"]), "--dev-metadata",
                str(md["dev"]), "--phones-dict", str(md["phones"])]
        opts = {"speedyspeech": fam_recipes.SS_OPTS
                + ["model.decoder_output_size", "8"],
                "tacotron2": fam_recipes.T2_OPTS + ["model.d_mels", "8"],
                "transformer_tts": fam_recipes.TT_OPTS}[family]
        if family == "speedyspeech":
            argv += ["--tones-dict", str(md["tones"])]
        train = {"speedyspeech": fam_recipes.ss_train,
                 "tacotron2": fam_recipes.t2_train,
                 "transformer_tts": fam_recipes.tt_train}[family]
        trainer = train.main(argv + [
            "--output-dir", str(tmp_path / "exp"), "--device", "cpu",
            "--opts", *opts, *bf16, "max_epoch", "1"])
        model, observed = _trained_model(trainer), trainer.observation
    assert any(getattr(m, "dtype", None) == BF16 for m in model.modules())
    assert observed and all(math.isfinite(float(v))
                            for v in observed.values())
    for name, p in model.named_parameters():
        want = BF16 if name.startswith("similarity_") else torch.float32
        assert p.dtype == want, name


def test_model_kwargs_give_every_family_bf16():
    """'bfloat16' in a model section is flax's ``dtype=`` for every family
    (the JAX package's ``resolve_model_kwargs`` gives ``jnp.bfloat16``);
    float16 still raises."""
    kw = resolve_model_kwargs({"dtype": "bfloat16"})
    assert kw == {"dtype": BF16}
    for family in FAMILIES:
        assert _port_model(family, kw["dtype"]) is not None
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        resolve_model_kwargs({"dtype": "float16"})


def test_bridge_carries_the_bf16_scale_of_ge2e():
    """JAX's GE2E at ``dtype=bfloat16`` creates its scale (w, b) in bf16:
    the bridge loads those leaves into the port's bf16 parameters bit for
    bit, the train state crosses with them, and ``flax_arrays`` gives them
    back (float32, exact)."""
    jm = _jax_model("ge2e")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 10, 6)))
    flat = {k: np.asarray(a) for k, a in flatten_tree(v).items()}
    for key in BF16_LEAVES:
        assert flat[key].dtype.name == "bfloat16"
    flat["params::similarity_weight"] = np.asarray(
        3.140625, flat["params::similarity_weight"].dtype)
    tm = _port_model("ge2e")
    load_flax_params(tm, flat)
    assert tm.similarity_weight.dtype == BF16
    assert tm.similarity_weight.item() == 3.140625
    assert tm.similarity_bias.item() == -5.0
    back = flax_arrays(tm)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], a.astype(np.float32),
                                      err_msg=key)
    # a JAX train state at bf16 (its scale's Adam moments in bf16) loads
    # into the port's, the moments in the parameters' dtypes
    tx = jbuild("adam", LR)
    jstate = JTrainState(step=jnp.asarray(3, jnp.int32),
                         params=v["params"], opt_state=tx.init(v["params"]),
                         batch_stats=None, rng=jax.random.PRNGKey(0))
    opt = build_optimizer(tm.parameters(), "adam", LR)
    state = tmodels.init_ge2e_train_state(tm, opt)
    load_train_state(state, {k: np.asarray(a)
                             for k, a in flatten_tree(jstate).items()})
    assert state.step == 3
    st = opt.inner.state[tm.similarity_weight]
    assert st["exp_avg"].dtype == BF16 and tm.similarity_weight.item() == 10.0


def test_flop_count_takes_the_float32_output_gemm():
    """``utils/flops.py`` counts the bf16 attention's float32-output GEMM
    (``torch.bmm(..., out_dtype=float32)`` on the card, which PyTorch's
    own formula refuses) as a plain product, on meta tensors."""
    a = torch.empty((3, 4, 5), dtype=BF16, device="meta")
    b = torch.empty((3, 5, 6), dtype=BF16, device="meta")
    with FlopCounterMode(display=False, custom_mapping=_BMM_DTYPE) as count:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a.float(), b.float())
        torch.mm(a[0], b[0], out_dtype=torch.float32)
    assert count.get_total_flops() == 2 * (2 * 3 * 4 * 5 * 6) + 2 * 4 * 5 * 6
