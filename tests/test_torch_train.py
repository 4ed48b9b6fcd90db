"""Parallel WaveGAN training of the PyTorch port against the JAX package.

Inputs, weights and noise are drawn with numpy and fed to both sides:
the STFT and its losses, the plain versions of kernels K2a/K2b against
the Pallas train stack (interpret mode, with the block constants made
small as tests/test_pwg_stack_train.py makes them, T > block), the
ResidualStack dispatch, the optimizer, the GAN objectives, and a short
Trainer run across the discriminator's warm-up boundary.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.ops.stft import dft_basis as j_dft_basis
from parakeet_tpu.ops.stft import stft as j_stft
from parakeet_tpu.ops.stft_loss import multi_resolution_stft_loss as j_mrstft
from parakeet_tpu.ops.pallas import pwg_stack as jstack
from parakeet_tpu.ops.pallas import pwg_stack_train as jstack_train
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.models import pwg_updater as tupd
from parakeet_tpu_torch.ops import stft as tstft
from parakeet_tpu_torch.ops import stft_loss as tloss
from parakeet_tpu_torch.ops.kernels import pwg_stack as tk1
from parakeet_tpu_torch.ops.kernels import pwg_stack_train as tk2
from parakeet_tpu_torch.training import (StandardUpdater, Trainer,
                                         build_optimizer, seed_everything)

torch.set_num_threads(1)

STFT_KW = dict(fft_sizes=(64, 128), hop_sizes=(16, 32), win_lengths=(32, 64))


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("impl", ["eager", "fused", "auto"])
@pytest.mark.parametrize("on_cuda", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_stack_route_keeps_k1_out_of_autograd(impl, on_cuda, grad):
    """K1 writes its outputs from a kernel, outside autograd: it may run
    only when no gradient is needed.  Under a gradient 'fused' trains
    through K2 and 'auto' runs eager, as the JAX 'pallas' and 'auto'."""
    route = tpwg.stack_route(impl, True, on_cuda, grad)
    want = {"eager": "eager",
            "fused": "train" if grad else "k1",
            "auto": "k1" if on_cuda and not grad else "eager"}[impl]
    assert route == want
    assert tpwg.stack_route(impl, False, on_cuda, grad) == (
        "eager" if impl == "auto" else want)


def test_stack_route_fused_training_refuses_dropout():
    with pytest.raises(ValueError, match="no dropout path"):
        tpwg.stack_route("fused", True, True, True, dropout=0.1)
    assert tpwg.stack_route("fused", True, True, False, dropout=0.1) == "k1"


# ------------------------------------------------------------------- STFT

@pytest.mark.parametrize("n_fft,hop,win", [(64, 16, 32), (128, 30, 128)])
def test_stft_matches_jax(n_fft, hop, win):
    x = _np(0, 2, 300)
    want_re, want_im = j_stft(jnp.asarray(x), n_fft, hop, win)
    got_re, got_im = tstft.stft(torch.from_numpy(x), n_fft, hop, win)
    np.testing.assert_allclose(got_re.numpy(), np.asarray(want_re),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(want_im),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(tstft.dft_basis(n_fft, win), j_dft_basis(n_fft, win)):
        np.testing.assert_array_equal(a, b)


def test_multi_resolution_stft_loss_and_grad_match_jax():
    """float32 sums of a few hundred products in other orders: 1e-5
    relative on the losses, 1e-4 of the range on the gradient."""
    x, y = _np(1, 2, 400, scale=0.3), _np(2, 2, 400, scale=0.3)

    def jl(x):
        sc, mag = j_mrstft(x, jnp.asarray(y),
                                                   **STFT_KW)
        return sc + mag, (sc, mag)

    (_, (want_sc, want_mag)), want_g = jax.jit(jax.value_and_grad(
        jl, has_aux=True))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    sc, mag = tloss.multi_resolution_stft_loss(tx, torch.from_numpy(y),
                                               **STFT_KW)
    (sc + mag).backward()
    np.testing.assert_allclose(sc.item(), float(want_sc), rtol=1e-5)
    np.testing.assert_allclose(mag.item(), float(want_mag), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=1e-3,
                               atol=1e-4 * np.abs(want_g).max())


# ------------------------------------------------------------- K2a / K2b

CR, CA, LAYERS, STACKS = 32, 20, 6, 3
DILS = tuple(2 ** (i % (LAYERS // STACKS)) for i in range(LAYERS))
# The plain K2a/K2b round where the Pallas kernels do (bf16 operands of
# every product, float32 sums, bf16 h, dso and dg, float32 dx, dh and
# dc); they differ in the order of float32 sums, which now and then flips
# a bf16 rounding by one ulp (2^-8 relative) and carries it on.  Held to
# 2^-6 of each output's range, four such ulps.  Measured at this shape:
# <= 0.0039 on the outputs, <= 0.0063 on the gradients.
K2_TOL = 2 ** -6


def _stack_weights(seed, scale=0.3):
    rng = np.random.default_rng(seed)

    def n(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(conv=n(LAYERS, 3, CR, 2 * CR), conv_b=n(LAYERS, 2 * CR),
                aux=n(LAYERS, CA, 2 * CR), skip=n(LAYERS, CR, CR),
                out=n(LAYERS, CR, CR), skip_b=n(LAYERS, CR),
                out_b=n(LAYERS, CR))


def test_k2_reference_matches_pallas_train_stack(monkeypatch):
    monkeypatch.setattr(jstack, "_BLOCK", 256)
    monkeypatch.setattr(jstack, "_HALO", 64)
    monkeypatch.setattr(jstack, "_SLACK", 32)
    monkeypatch.setattr(jstack_train, "_BWD_BLOCK", 128)
    b, t = 2, 300
    x, c = _np(3, b, t, CR), _np(4, b, t, CA)
    w = _stack_weights(5)
    wx, ws = _np(6, b, t, CR), _np(7, b, t, CR)
    (want_x, want_s), vjp = jax.vjp(
        lambda x, c, w: jstack_train.fused_residual_stack_train(
            x, c, w, dilations=DILS, stacks=STACKS),
        jnp.asarray(x), jnp.asarray(c),
        {k: jnp.asarray(v) for k, v in w.items()})
    want_dx, want_dc, want_dw = vjp((jnp.asarray(wx), jnp.asarray(ws)))

    tx = torch.tensor(x, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tk2.fused_group_backward.launches = 0
    got_x, got_s = tk2.fused_residual_stack_train(tx, tc, tw, dilations=DILS,
                                                  stacks=STACKS)
    ((got_x * torch.from_numpy(wx)).sum()
     + (got_s * torch.from_numpy(ws)).sum()).backward()
    assert tk2.fused_group_backward.launches == 0     # plain on the CPU
    pairs = [("x", got_x.detach(), want_x), ("skip", got_s.detach(), want_s),
             ("dx", tx.grad, want_dx), ("dc", tc.grad, want_dc)]
    pairs += [(f"d{k}", tw[k].grad, want_dw[k]) for k in w]
    for name, got, want in pairs:
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max()
        assert err <= K2_TOL * np.abs(want).max(), f"{name}: {err}"


def test_k2a_saves_each_layers_input_as_k1_computes_it():
    """The save forward (K2a) gives K1's outputs and, per layer, the bf16
    input that layer's products read."""
    b, t = 2, 90
    x, c = torch.from_numpy(_np(8, b, t, CR)), torch.from_numpy(
        _np(9, b, t, CA))
    w = {k: torch.from_numpy(v) for k, v in _stack_weights(10).items()}
    wg, wso, bso = tk1.pack_stack_weights(w, CR, CA)
    per = LAYERS // STACKS
    xs = x
    for g in range(STACKS):
        sl = slice(g * per, (g + 1) * per)
        nxt, skip, saved = tk1.fused_group_forward_save(
            xs, c.to(torch.bfloat16), wg[sl].to(torch.bfloat16),
            wso[sl].to(torch.bfloat16), bso[sl], dilations=DILS[sl])
        assert saved.shape == (per, b, t, CR) and saved.dtype == torch.bfloat16
        torch.testing.assert_close(saved[0].float(),
                                   xs.to(torch.bfloat16).float())
        xs = nxt
    want_x, _ = tk1.fused_residual_stack_reference(x, c, w, dilations=DILS,
                                                   stacks=STACKS)
    torch.testing.assert_close(xs, want_x.float(), rtol=0, atol=0)


def _module_stack(impl, seed):
    stack = tpwg.ResidualStack(layers=LAYERS, stacks=STACKS,
                               residual_channels=CR, gate_channels=2 * CR,
                               skip_channels=CR, aux_channels=CA, impl=impl)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in stack.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return stack


def test_fused_stack_trains_like_the_eager_stack():
    """'fused' under autograd runs the K2 groups (their plain versions on
    the CPU) through the weight-norm fold, and its gradients of every
    parameter, x and c agree with autograd through the float32 eager
    stack to bf16 accuracy: 5% of each gradient's range, the tolerance
    tests/test_pwg_stack_train.py holds the Pallas kernels to."""
    fused, eager = _module_stack("fused", 11), _module_stack("eager", 11)
    x, c = _np(12, 2, 120, CR), _np(13, 2, 120, CA)
    wx, ws = torch.from_numpy(_np(14, 2, 120, CR)), torch.from_numpy(
        _np(15, 2, 120, CR))
    grads = []
    for stack in (fused, eager):
        tx = torch.tensor(x, requires_grad=True)
        tc = torch.tensor(c, requires_grad=True)
        xf, sk = stack(tx, tc)
        ((xf * wx).sum() + (sk * ws).sum()).backward()
        grads.append([tx.grad, tc.grad] + [p.grad for p in stack.parameters()])
    for got, want in zip(*grads):
        assert got is not None and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 0.05 * want.abs().max().item() + 1e-6


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("case", ["adam", "adam_clip", "adam_decay",
                                  "adamw"])
def test_build_optimizer_steps_like_optax(case):
    """Two updates of the same parameters with the same gradients; float32
    arithmetic in other orders: 1e-6 of the parameters."""
    from parakeet_tpu.training.optimizer import build_optimizer as jbuild
    kw = {"adam": dict(optim="adam"),
          "adam_clip": dict(optim="adam", max_grad_norm=0.5),
          "adam_decay": dict(optim="adam", weight_decay=0.1),
          "adamw": dict(optim="adamw", weight_decay=0.1)}[case]
    lr = (lambda count: 1e-2 * 0.5 ** count)      # a schedule, per update
    p0, g1, g2 = _np(16, 5, 3), _np(17, 5, 3), _np(18, 5, 3)
    tx = jbuild(learning_rate=lr, **kw)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    for g in (g1, g2):
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer([w], learning_rate=lr, **kw)
    for g in (g1, g2):
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- GAN updater

GEN_CFG = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
               skip_channels=32, aux_channels=10, aux_context_window=1,
               upsample_scales=(2, 3))
DISC_CFG = dict(layers=4, conv_channels=16)
FRAMES = 14                       # 12 + 2 * aux_context_window


def _randomized(flat, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif leaf.endswith("bias"):
            v = 0.05 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    return out


def _gan_pair(noise, mel, wav):
    """(JAX modules, their variables, port modules with the same weights,
    flat trees) for the objective tests."""
    jg = jpwg.PWGGenerator(stack_impl="xla", **GEN_CFG)
    jd = jpwg.PWGDiscriminator(impl="xla", **DISC_CFG)
    fg = _randomized(flatten_tree(jax.jit(jg.init)(
        jax.random.PRNGKey(0), jnp.asarray(noise), jnp.asarray(mel))), 20)
    fd = _randomized(flatten_tree(jax.jit(jd.init)(
        jax.random.PRNGKey(0), jnp.asarray(wav[..., None]))), 21)
    tg = tpwg.PWGGenerator(stack_impl="eager", **GEN_CFG)
    td = tpwg.PWGDiscriminator(impl="eager", **DISC_CFG)
    load_flax_params(tg, fg)
    load_flax_params(td, fd)
    return jg, jd, nest_flat(fg), nest_flat(fd), tg, td


def _assert_grads_match(module, jax_grads, tol):
    """Each parameter's .grad against the JAX gradient tree, laid out as
    the module's parameters by the weight bridge.  The 1e-5 floor is for
    gradients that are zero up to float32 noise: weight norm over one
    input channel (first_conv) leaves the kernel's direction fixed."""
    want = copy.deepcopy(module)
    load_flax_params(want, flatten_tree({"params": jax_grads}))
    wanted = dict(want.named_parameters())
    for name, p in module.named_parameters():
        w = wanted[name].detach()
        assert p.grad is not None, name
        err = (p.grad - w).abs().max().item()
        assert err <= tol * w.abs().max().item() + 1e-5, (name, err)


def _gan_inputs():
    t = (FRAMES - 2) * 6
    return (_np(22, 2, t, 1), _np(23, 2, FRAMES, 10),
            _np(24, 2, t, scale=0.3))


@pytest.mark.parametrize("disc_on", [False, True])
def test_generator_objective_matches_jax(disc_on):
    """Loss and every generator gradient of the update's objective
    (pwg_updater.py:91-117), float32 eager modules on both sides: 1e-5
    on the losses, 1e-3 of each gradient's range (float32 sums in other
    orders through the STFT, the stack and the discriminator)."""
    noise, mel, wav = _gan_inputs()
    jg, jd, vg, vd, tg, td = _gan_pair(noise, mel, wav)
    lam = 4.0

    def loss_fn(gp):
        fake = jg.apply({"params": gp}, jnp.asarray(noise), jnp.asarray(mel))
        sc, mag = j_mrstft(
            fake[..., 0], jnp.asarray(wav), **STFT_KW)
        adv = jnp.mean(jnp.square(jd.apply(vd, fake) - 1.0))
        return sc + mag + (lam * adv if disc_on else 0.0), (sc, mag, adv)

    (want, (_, _, want_adv)), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(vg["params"])
    got, (_, _, adv) = tupd.generator_objective(
        tg, td, torch.from_numpy(noise), torch.from_numpy(mel),
        torch.from_numpy(wav), lambda_adv=lam, disc_on=disc_on,
        stft_kw=STFT_KW)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if disc_on:
        np.testing.assert_allclose(adv.item(), float(want_adv), rtol=1e-5)
    _assert_grads_match(tg, want_g, 1e-3)
    # the discriminator's weights are constants of the generator's loss
    assert all(p.grad is None and p.requires_grad for p in td.parameters())


def test_discriminator_objective_matches_jax():
    """pwg_updater.py:143-153 on a given fake: losses 1e-5, gradients
    1e-4 of their range."""
    noise, mel, wav = _gan_inputs()
    jg, jd, vg, vd, tg, td = _gan_pair(noise, mel, wav)
    fake = np.array(jax.jit(jg.apply)(vg, jnp.asarray(noise),
                                      jnp.asarray(mel)))

    def loss_fn(dp):
        real = jnp.mean(jnp.square(
            jd.apply({"params": dp}, jnp.asarray(wav[..., None])) - 1.0))
        fk = jnp.mean(jnp.square(jd.apply({"params": dp},
                                          jnp.asarray(fake))))
        return real + fk

    want, want_g = jax.jit(jax.value_and_grad(loss_fn))(vd["params"])
    got, _ = tupd.discriminator_objective(td, torch.from_numpy(wav),
                                          torch.from_numpy(fake))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads_match(td, want_g, 1e-4)


def test_trainer_runs_across_the_warmup_boundary(tmp_path):
    """Three Trainer steps of the GAN updater with the fused impls (their
    plain versions on the CPU) and discriminator_train_start_steps=2:
    steps 0-1 leave the discriminator alone, step 2 trains it."""
    gen = torch.Generator().manual_seed(0)
    g = tpwg.PWGGenerator(stack_impl="fused", **GEN_CFG)
    d = tpwg.PWGDiscriminator(impl="fused")
    for m in (g, d):
        with torch.no_grad():
            for name, p in m.named_parameters():
                if not name.endswith("scale"):
                    p.copy_(torch.randn(p.shape, generator=gen)
                            / math.sqrt(max(p[0].numel(), 1)))
    g_opt = build_optimizer(g.parameters(), "adam", learning_rate=1e-3)
    d_opt = build_optimizer(d.parameters(), "adam", learning_rate=5e-4)
    state = tupd.init_pwg_train_state(g, d, g_opt, d_opt, seed_everything(0))
    step = tupd.make_pwg_train_step(g, d, discriminator_train_start_steps=2,
                                    **STFT_KW)
    t = (FRAMES - 2) * 6
    batches = [dict(wav=torch.from_numpy(_np(30 + i, 2, t, scale=0.3)),
                    mel=torch.from_numpy(_np(40 + i, 2, FRAMES, 10)))
               for i in range(3)]
    snapshots, seen = [], []

    def watch(trainer):
        seen.append({k: float(v) for k, v in
                     trainer.updater.last_metrics.items()})
        snapshots.append([p.detach().clone() for p in d.parameters()])

    updater = StandardUpdater(step, state, batches)
    trainer = Trainer(updater, stop_trigger=(3, "iteration"),
                      out=str(tmp_path), extensions=[watch])
    d0 = [p.detach().clone() for p in d.parameters()]
    g0 = [p.detach().clone() for p in g.parameters()]
    trainer.run()
    assert updater.state.iteration == 3 and state.step == 3
    assert all(math.isfinite(v) for m in seen for v in m.values())
    assert [m["adversarial_loss"] == 0.0 for m in seen] == [True, True, False]
    assert [m["discriminator_loss"] == 0.0 for m in seen] == [True, True,
                                                             False]
    assert all(torch.equal(a, b) for a, b in zip(d0, snapshots[1]))
    assert not all(torch.equal(a, b) for a, b in zip(d0, snapshots[2]))
    assert not any(torch.equal(a, b.detach())
                   for a, b in zip(g0, g.parameters()))


def test_eval_step_is_the_losses_of_a_fixed_noise():
    """make_pwg_eval_step draws its noise from a generator seeded 0 on
    every call (the JAX step uses PRNGKey(0)): two calls agree exactly,
    and the generator loss is sc + mag + lambda_adv * adv."""
    noise, mel, wav = _gan_inputs()
    *_, tg, td = _gan_pair(noise, mel, wav)
    step = tupd.make_pwg_eval_step(tg, td, lambda_adv=4.0, **STFT_KW)
    batch = {"wav": torch.from_numpy(wav), "mel": torch.from_numpy(mel)}
    first, second = step(None, batch), step(None, batch)
    assert first.keys() == {"generator_loss", "spectral_convergence_loss",
                            "log_stft_magnitude_loss", "adversarial_loss"}
    for k in first:
        assert torch.isfinite(first[k]) and torch.equal(first[k], second[k])
    torch.testing.assert_close(
        first["generator_loss"],
        first["spectral_convergence_loss"]
        + first["log_stft_magnitude_loss"]
        + 4.0 * first["adversarial_loss"])


def test_schedules_match_optax_schedules():
    from parakeet_tpu.training import optimizer as jopt
    from parakeet_tpu_torch.training import optimizer as topt
    pairs = [(jopt.step_decay_schedule(0.1, 3, 0.5),
              topt.step_decay_schedule(0.1, 3, 0.5)),
             (jopt.piecewise_schedule([2, 5], [1.0, 0.1, 0.01]),
              topt.piecewise_schedule([2, 5], [1.0, 0.1, 0.01])),
             (jopt.constant_schedule(0.3), topt.constant_schedule(0.3))]
    for want, got in pairs:
        for count in range(8):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6)


def test_trainer_writes_a_profile_window(tmp_path):
    """profiler_options: a torch.profiler trace of iterations [1, 2)."""
    from parakeet_tpu_torch.training import UpdaterBase

    class Counter(UpdaterBase):
        def update(self):
            torch.ones(4).sum()
            self.state.iteration += 1

    trace_dir = tmp_path / "trace"
    trainer = Trainer(Counter(), stop_trigger=(3, "iteration"),
                      out=str(tmp_path / "out"),
                      profiler_options=f"batch_range=[1,2];"
                                       f"profile_path={trace_dir}")
    trainer.run()
    assert (trace_dir / "trace.json").stat().st_size > 0
