"""Parallel WaveGAN's options beyond the released configuration, in the
port against the JAX package on the same parameters and inputs: the
upsampler's nonlinearity, ``freq_axis_kernel_size`` and causal variant,
the causal residual stack, the stack's dropout (the JAX keep-masks handed
to the port), ``ResidualPWGDiscriminator``, the mel functions of
``ops/stft.py``, the refusals of the fused routes, and one mixed-precision
(bf16) GAN step of the updater.

float32 modules are held to 1e-5 (sums in other orders), the mel
functions to 1e-5 of their range (float32 DFT products over n_fft taps).
The bf16 step's losses are held to 2^-7 relative and its gradients to
2^-5 relative L2 of each network's whole gradient: both packages round
at the same points (bf16 operands and conv outputs, float32 sums, float32
losses), and a different float32 sum order flips a bf16 rounding now and
then.  That is far inside the 15% band in which JAX's
``tests/test_chain_pallas_train.py`` holds its bf16 training run to the
float32 one.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.models import pwg_updater as jupd
from parakeet_tpu.ops.stft import log_mel_spectrogram as j_log_mel
from parakeet_tpu.ops.stft import mel_spectrogram as j_mel
from parakeet_tpu.ops.stft_loss import multi_resolution_stft_loss as j_mr
from parakeet_tpu.training.checkpoint import flatten_tree
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu_torch.bridge import flax_arrays, flax_grads, load_flax_params
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.models import pwg_updater as tupd
from parakeet_tpu_torch.ops import stft as tstft
from parakeet_tpu_torch.training import (build_optimizer,
                                         resolve_model_kwargs)

from test_torch_pwg import _init

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STACK = dict(layers=6, stacks=3, kernel_size=3, residual_channels=16,
             gate_channels=32, skip_channels=16, aux_channels=10)


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -------------------------------------------------------------- upsampler

@pytest.mark.parametrize("kf", [1, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_upsampler_options_match_jax(kf, causal):
    """ConvInUpsampleNet with a LeakyReLU (Paddle's class name and its
    ``negative_slope``) after each scale, an FIR over kf mel channels, and
    the causal context window and phase masks."""
    kw = dict(aux_channels=6, aux_context_window=2, freq_axis_kernel_size=kf,
              nonlinear_activation="LeakyReLU",
              nonlinear_activation_params={"negative_slope": 0.3},
              use_causal_conv=causal)
    jm = jpwg.ConvInUpsampleNet((2, 3), **kw)
    tm = tpwg.ConvInUpsampleNet((2, 3), **kw)
    x = _np(3, 2, 12, 6)
    flat, variables = _init(jm, 4, jnp.asarray(x))
    load_flax_params(tm, flat)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = tm(_t(x)).detach().numpy()
    assert got.shape == want.shape == (2, 8 * 6, 6)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for s in (2, 3, 5):
        np.testing.assert_array_equal(tpwg._phase_masks(s, causal),
                                      jpwg._phase_masks(s, causal))


def test_generator_with_upsampler_options_matches_jax():
    kw = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
              skip_channels=8, aux_channels=6, upsample_scales=(2, 3),
              freq_axis_kernel_size=3, nonlinear_activation="LeakyReLU",
              nonlinear_activation_params={"negative_slope": 0.2})
    jm = jpwg.PWGGenerator(**kw)
    tm = tpwg.PWGGenerator(**kw)
    noise, mel = _np(1, 1, 30, 1), _np(2, 1, 9, 6)
    flat, variables = _init(jm, 5, jnp.asarray(noise), jnp.asarray(mel))
    load_flax_params(tm, flat)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(noise),
                                        jnp.asarray(mel)))
    np.testing.assert_allclose(tm(_t(noise), _t(mel)).detach().numpy(),
                               want, **F32_TOL)


# ----------------------------------------------------------- causal stack

def test_causal_conv1d_taps_matches_jax():
    x, kernel = _np(0, 2, 17, 6), _np(1, 3, 6, 5)
    for dil in (1, 4):
        want = jpwg.conv1d_taps(jnp.asarray(x), jnp.asarray(kernel), dil,
                                "CAUSAL")
        got = tpwg.conv1d_taps(_t(x), _t(kernel), dil, "CAUSAL")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_causal_stack_matches_jax():
    """'auto' runs a causal stack eager (never fused), forward and
    gradients."""
    x, c = _np(5, 2, 40, 16), _np(6, 2, 40, 10)
    jm = jpwg.ResidualStack(impl="auto", use_causal_conv=True, **STACK)
    flat, variables = _init(jm, 7, jnp.asarray(x), jnp.asarray(c))
    tm = tpwg.ResidualStack(impl="auto", use_causal_conv=True, **STACK)
    load_flax_params(tm, flat)
    assert not tm.supported

    def jloss(params):
        xf, skips = jm.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(c))
        return jnp.sum(xf * 0.3) + jnp.sum(skips), (xf, skips)

    value_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (_, (want_x, want_s)), jg = value_and_grad(variables["params"])
    got_x, got_s = tm(_t(x), _t(c))
    (torch.sum(got_x * 0.3) + torch.sum(got_s)).backward()
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x),
                               **F32_TOL)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **F32_TOL)
    want_g = flatten_tree({"params": jg})
    got_g = flax_grads(tm)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_fused_routes_refuse_what_they_cannot_run():
    """A causal stack under 'fused' and 'fused' training with dropout
    raise, as the JAX 'pallas' does."""
    with pytest.raises(ValueError, match="unsupported"):
        tpwg.ResidualStack(impl="fused", use_causal_conv=True, **STACK)
    x, c = _np(5, 1, 40, 16), _np(6, 1, 40, 10)
    jm = jpwg.ResidualStack(impl="pallas", use_causal_conv=True, **STACK)
    with pytest.raises(ValueError, match="unsupported"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c))

    fusable = dict(STACK, residual_channels=32, gate_channels=64,
                   skip_channels=32)
    x = _np(5, 1, 40, 32)
    tm = tpwg.ResidualStack(impl="fused", dropout=0.1, **fusable)
    with pytest.raises(ValueError, match="no dropout path"):
        tm(_t(x), _t(c), deterministic=False,
           rng=torch.Generator().manual_seed(0))
    jm = jpwg.ResidualStack(impl="pallas", dropout=0.1, **fusable)
    with pytest.raises(ValueError, match="no dropout path"):
        jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x),
                jnp.asarray(c), deterministic=False)
    # inference drops nothing: K1's route stays open
    assert tpwg.stack_route("fused", True, True, False, dropout=0.1,
                            deterministic=True) == "k1"
    assert tpwg.stack_route("auto", True, True, False, dropout=0.1,
                            deterministic=False) == "eager"


# ---------------------------------------------------------------- dropout

def _jax_keep_masks(jm, variables, x, c, key):
    """The keep-masks the JAX stack's dropout draws from ``key``: where
    each layer's dropped input is non-zero (the inputs are)."""
    _, state = jm.apply(variables, jnp.asarray(x), jnp.asarray(c),
                        deterministic=False, rngs={"dropout": key},
                        capture_intermediates=lambda mdl, _: isinstance(
                            mdl, fnn.Dropout),
                        mutable=["intermediates"])
    outs = state["intermediates"]["Dropout_0"]["__call__"]
    return [torch.from_numpy(np.asarray(o) != 0) for o in outs]


@pytest.mark.parametrize("layers_impl", ["eager", "auto"])
def test_stack_dropout_with_keep_masks_matches_jax(layers_impl,
                                                   monkeypatch):
    """The training forward and its gradients (each layer recomputed in
    the backward) with JAX's keep-masks handed to the port's dropout."""
    x, c = _np(8, 2, 40, 16), _np(9, 2, 40, 10)
    jm = jpwg.ResidualStack(impl="xla", dropout=0.3, **STACK)
    flat, variables = _init(jm, 10, jnp.asarray(x), jnp.asarray(c))
    key = jax.random.PRNGKey(3)
    masks = _jax_keep_masks(jm, variables, x, c, key)
    assert len(masks) == STACK["layers"]
    assert 0.5 < float(torch.stack(masks).float().mean()) < 0.9

    def jloss(params):
        xf, skips = jm.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(c), deterministic=False,
                             rngs={"dropout": key})
        return jnp.sum(xf * 0.3) + jnp.sum(skips), (xf, skips)

    value_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (_, (want_x, want_s)), jg = value_and_grad(variables["params"])
    tm = tpwg.ResidualStack(impl=layers_impl, dropout=0.3, **STACK)
    load_flax_params(tm, flat)
    handed = list(masks)
    monkeypatch.setattr(tm.dropout, "keep_mask",
                        lambda shape, rng, device: handed.pop(0))
    got_x, got_s = tm(_t(x), _t(c), deterministic=False,
                      rng=torch.Generator().manual_seed(0))
    assert not handed
    (torch.sum(got_x * 0.3) + torch.sum(got_s)).backward()
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x),
                               **F32_TOL)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **F32_TOL)
    want_g = flatten_tree({"params": jg})
    got_g = flax_grads(tm)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # deterministic: no mask is drawn, the output is the plain stack's
    with torch.no_grad():
        plain = tm(_t(x), _t(c))[0]
    want_plain = jm.apply(variables, jnp.asarray(x), jnp.asarray(c))[0]
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_plain),
                               **F32_TOL)


def test_train_step_regenerates_the_fake_with_the_same_masks(monkeypatch):
    """The discriminator update sees the fake of the generator update's
    dropout masks: the regeneration draws them again from the state's
    generator as it stood before the update's forward."""
    kw = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
              skip_channels=8, aux_channels=6, upsample_scales=(2, 3),
              dropout=0.5)
    g = tpwg.PWGGenerator(**kw)
    d = tpwg.PWGDiscriminator(layers=3, conv_channels=8)
    gen = torch.Generator().manual_seed(0)
    tpwg.init_pwg_params_(g, gen)
    tpwg.init_pwg_params_(d, gen)
    drawn = []
    keep_mask = g.stack.dropout.keep_mask

    def spy(shape, rng, device):
        drawn.append(keep_mask(shape, rng, device))
        return drawn[-1]

    monkeypatch.setattr(g.stack.dropout, "keep_mask", spy)
    state = tupd.init_pwg_train_state(
        g, d, build_optimizer(g.parameters(), "adam", 1e-3),
        build_optimizer(d.parameters(), "adam", 1e-3),
        torch.Generator().manual_seed(1))
    step = tupd.make_pwg_train_step(
        g, d, discriminator_train_start_steps=0, fft_sizes=(64,),
        hop_sizes=(16,), win_lengths=(32,))
    batch = {"wav": _t(_np(2, 2, 48, scale=0.3)), "mel": _t(_np(3, 2, 12, 6))}
    n = kw["layers"]

    _, metrics = step(state, batch)
    assert len(drawn) == 2 * n
    for a, b in zip(drawn[:n], drawn[n:]):
        assert torch.equal(a, b)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    # the state's generator moved past the masks: the next step draws anew
    first = drawn[:n]
    drawn.clear()
    step(state, batch)
    assert len(drawn) == 2 * n
    assert not all(torch.equal(a, b) for a, b in zip(first, drawn[:n]))


# --------------------------------------------- ResidualPWGDiscriminator

def test_residual_discriminator_matches_jax():
    kw = dict(layers=6, stacks=3, residual_channels=16, gate_channels=32,
              skip_channels=16)
    jm = jpwg.ResidualPWGDiscriminator(**kw)
    tm = tpwg.ResidualPWGDiscriminator(**kw)
    x = _np(11, 2, 64, 1)
    flat, variables = _init(jm, 12, jnp.asarray(x))
    load_flax_params(tm, flat)
    assert sorted(flax_arrays(tm)) == sorted(flat)

    def jloss(params):
        y = jm.apply({"params": params}, jnp.asarray(x))
        return jnp.mean(jnp.square(y - 1.0)), y

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    got = tm(_t(x))
    torch.mean(torch.square(got - 1.0)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    want_g = flatten_tree({"params": jg})
    got_g = flax_grads(tm)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    from parakeet_tpu_torch.models import ResidualPWGDiscriminator
    assert ResidualPWGDiscriminator is tpwg.ResidualPWGDiscriminator


# --------------------------------------------------------- mel functions

MEL_KW = dict(sr=24000, n_fft=512, hop_length=120, win_length=400,
              n_mels=40, fmin=80.0, fmax=7600.0)


def test_mel_spectrogram_matches_jax():
    x = _np(13, 2, 4000, scale=0.3)
    want = np.asarray(j_mel(jnp.asarray(x), **MEL_KW))
    got = tstft.mel_spectrogram(_t(x), **MEL_KW).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("base", ["10", "e"])
def test_log_mel_spectrogram_matches_jax(base):
    x = _np(14, 2, 4000, scale=0.3)
    want = np.asarray(j_log_mel(jnp.asarray(x), base=base, **MEL_KW))
    got = tstft.log_mel_spectrogram(_t(x), base=base, **MEL_KW).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ------------------------------------------------ mixed precision (bf16)

def test_resolve_model_kwargs_takes_bfloat16_for_pwg_only():
    """'bfloat16' is the PWG modules' compute dtype, as every family's
    (the flag that once held it to them is gone); float32 is dropped and
    any other dtype raises."""
    assert resolve_model_kwargs({"dtype": "bfloat16"}) == {
        "dtype": torch.bfloat16}
    assert resolve_model_kwargs({"dtype": "float32", "layers": 3}) == {
        "layers": 3}
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        resolve_model_kwargs({"dtype": "float16"})
    kw = resolve_model_kwargs({"dtype": "bf16", **GAN_DISC})
    disc = tpwg.PWGDiscriminator(**kw)
    assert disc.dtype == torch.bfloat16
    assert {p.dtype for p in disc.parameters()} == {torch.float32}


GAN_GEN = dict(layers=4, stacks=2, residual_channels=16, gate_channels=32,
               skip_channels=16, aux_channels=10, upsample_scales=(2, 3))
GAN_DISC = dict(layers=4, conv_channels=16)
GAN_STFT = dict(fft_sizes=(128, 64), hop_sizes=(32, 16),
                win_lengths=(96, 48))


def _rel_l2(got: dict, want: dict) -> float:
    keys = sorted(want)
    g = np.concatenate([np.asarray(got[k], np.float64).ravel()
                        for k in keys])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in keys])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _exact(fn, *args):
    """``fn`` jitted without XLA's excess precision: each bf16 result is
    rounded where the program says, as JAX computes it op by op (by
    default XLA may drop a float32 -> bf16 -> float32 pair of converts)."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    return fn.lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)


def test_mixed_bf16_gan_step_matches_jax(monkeypatch):
    """One GAN step (the discriminator live) of the port's updater at
    dtype bfloat16 against the JAX updater's at ``dtype=jnp.bfloat16``,
    on the same float32 parameters, batch and noise: the metrics, both
    networks' gradients and the parameters after Adam."""
    jg = jpwg.PWGGenerator(dtype=jnp.bfloat16, stack_impl="xla", **GAN_GEN)
    jd = jpwg.PWGDiscriminator(dtype=jnp.bfloat16, **GAN_DISC)
    b, frames = 2, 16
    t = frames * 6
    wav = _np(20, b, t, scale=0.3)
    mel = _np(21, b, frames + 4, GAN_GEN["aux_channels"])
    gflat, gvars = _init(jg, 22, jnp.zeros((b, t, 1)), jnp.asarray(mel))
    dflat, dvars = _init(jd, 23, jnp.zeros((b, t, 1)))
    lr_g, lr_d = 1e-3, 5e-4
    gtx, dtx = jbuild("adam", lr_g), jbuild("adam", lr_d)
    key = jax.random.PRNGKey(5)
    # the noise the JAX step draws
    _, noise_key, _ = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(noise_key, (b, t, 1)))
    jstate = jupd.init_pwg_train_state(gvars["params"], dvars["params"],
                                       gtx, dtx, key)
    jstep = jupd.make_pwg_train_step(jg, jd, gtx, dtx,
                                     discriminator_train_start_steps=0,
                                     **GAN_STFT)
    jnew, jmetrics = _exact(jstep, jstate, {"wav": jnp.asarray(wav),
                                            "mel": jnp.asarray(mel)})

    # the JAX gradients of the step's two objectives
    def g_loss(p):
        fake = jg.apply({"params": p}, jnp.asarray(noise), jnp.asarray(mel),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        sc, mag = j_mr(fake[..., 0], jnp.asarray(wav), **GAN_STFT)
        adv = jnp.mean(jnp.square(jd.apply(dvars, fake).astype(
            jnp.float32) - 1.0))
        return sc + mag + 4.0 * adv

    def d_loss(p, fake):
        real = jd.apply({"params": p}, jnp.asarray(wav)[..., None])
        fk = jd.apply({"params": p}, fake)
        return (jnp.mean(jnp.square(real.astype(jnp.float32) - 1.0))
                + jnp.mean(jnp.square(fk.astype(jnp.float32))))

    jgrad_g = _exact(jax.grad(g_loss), gvars["params"])
    fake_new = _exact(jg.apply, {"params": jnew.params["generator"]},
                      jnp.asarray(noise), jnp.asarray(mel))
    jgrad_d = _exact(jax.grad(d_loss), dvars["params"], fake_new)

    kw = resolve_model_kwargs({"dtype": "bfloat16", "stack_impl": "xla"})
    tg = tpwg.PWGGenerator(**kw, **GAN_GEN)
    td = tpwg.PWGDiscriminator(dtype=kw["dtype"], **GAN_DISC)
    load_flax_params(tg, gflat)
    load_flax_params(td, dflat)
    state = tupd.init_pwg_train_state(
        tg, td, build_optimizer(tg.parameters(), "adam", lr_g),
        build_optimizer(td.parameters(), "adam", lr_d),
        torch.Generator().manual_seed(0))
    step = tupd.make_pwg_train_step(tg, td,
                                    discriminator_train_start_steps=0,
                                    **GAN_STFT)
    real_randn = torch.randn
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **k: torch.from_numpy(noise.copy()))
    _, metrics = step(state, {"wav": _t(wav), "mel": _t(mel)})
    monkeypatch.setattr(torch, "randn", real_randn)

    for name, want in jmetrics.items():
        want = float(want)
        assert abs(float(metrics[name]) - want) <= 2 ** -7 * abs(want), name
    for mod, jgrad in ((tg, jgrad_g), (td, jgrad_d)):
        want = flatten_tree({"params": jgrad})
        got = flax_grads(mod)
        assert sorted(got) == sorted(want)
        assert _rel_l2(got, want) <= 2 ** -5
    # parameters, gradients and Adam's moments stay float32
    for mod in (tg, td):
        for p in mod.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
    for opt in state.optimizers.values():
        for st in opt.inner.state.values():
            assert st["exp_avg"].dtype == torch.float32
    # one Adam step of lr moves each parameter by at most about lr; the
    # moved parameters agree with JAX's within a tenth of the step
    for name, mod, lr in (("generator", tg, lr_g),
                          ("discriminator", td, lr_d)):
        want = flatten_tree({"params": jnew.params[name]})
        got = flax_arrays(mod)
        moved = np.concatenate([np.abs(got[k] - (gflat if mod is tg
                                                 else dflat)[k]).ravel()
                                for k in want])
        assert moved.max() <= 1.01 * lr
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel()
                                for k in want])
        assert np.mean(diffs <= 0.1 * lr) >= 0.99
