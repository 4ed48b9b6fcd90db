"""Parallel WaveGAN training step (counterpart of
``parakeet_tpu/models/pwg_updater.py``).

Generator loss = multi-resolution STFT (sc + mag) + lambda_adv *
MSE(D(y^), 1) once the state's step reaches
``discriminator_train_start_steps``; discriminator loss = MSE(D(y), 1) +
MSE(D(y^), 0), with the fake regenerated from the *updated* generator
under ``torch.no_grad()`` (so a 'fused' stack regenerates through K1).

The warm-up gate is a plain host ``if`` on ``state.step``: PyTorch runs
eagerly, so there are no two compiled programs to choose between, and
reading the step from the state (not from a host mirror of it) keeps the
gate right when states are not fed in sequence (the JAX dispatcher's
drifting mirror, ROADMAP queue 3).  Noise comes from the state's
generator, and so do the generator's dropout masks (its training forward,
``deterministic=False``): the regeneration replays the generator's state
from before the update's forward, so the discriminator sees the fake of
the same masks, as the JAX step reuses its dropout key.  Losses reduce in
float32, whatever the networks' compute dtype; parameters and Adam state
stay float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from ..ops.stft_loss import multi_resolution_stft_loss
from ..training.state import TrainState

__all__ = ["make_pwg_train_step", "make_pwg_eval_step",
           "init_pwg_train_state", "generator_objective",
           "discriminator_objective"]


def _mse(x: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.square(x.float() - target))


def init_pwg_train_state(generator, discriminator, gen_optimizer,
                         disc_optimizer, rng: torch.Generator) -> TrainState:
    return TrainState(
        step=0,
        modules={"generator": generator, "discriminator": discriminator},
        optimizers={"generator": gen_optimizer,
                    "discriminator": disc_optimizer},
        rng=rng)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """No parameter of ``module`` requires grad inside the block (its
    weights are constants of the other network's loss)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def generator_objective(generator, discriminator, noise, mel, wav, *,
                        lambda_adv: float, disc_on: bool, stft_kw: Dict,
                        rng: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Tuple]:
    """(loss, (sc_loss, mag_loss, adv_loss)) of the generator update (its
    training forward, dropout drawn from ``rng``); the discriminator's
    weights are treated as constants."""
    fake = generator(noise, mel, deterministic=False, rng=rng)
    sc_loss, mag_loss = multi_resolution_stft_loss(fake[..., 0], wav,
                                                   **stft_kw)
    if disc_on:
        with _frozen(discriminator):
            adv_loss = _mse(discriminator(fake), 1.0)
        loss = sc_loss + mag_loss + lambda_adv * adv_loss
    else:
        adv_loss = torch.zeros((), device=wav.device)
        loss = sc_loss + mag_loss
    return loss, (sc_loss, mag_loss, adv_loss)


def discriminator_objective(discriminator, wav, fake
                            ) -> Tuple[torch.Tensor, Tuple]:
    """(loss, (real_loss, fake_loss)); ``fake`` carries no gradient."""
    real_loss = _mse(discriminator(wav[..., None]), 1.0)
    fake_loss = _mse(discriminator(fake.detach()), 0.0)
    return real_loss + fake_loss, (real_loss, fake_loss)


def make_pwg_train_step(generator, discriminator, *,
                        lambda_adv: float = 4.0,
                        discriminator_train_start_steps: int = 100000,
                        fft_sizes=(1024, 2048, 512),
                        hop_sizes=(120, 240, 50),
                        win_lengths=(600, 1200, 240)):
    """Build ``(TrainState, {wav, mel}) -> (TrainState, metrics)``.

    ``generator`` and ``discriminator`` are the modules the state holds;
    the step updates them and the state's optimizers in place.  Metrics
    are detached 0-d tensors (reading them waits for the device).
    """
    stft_kw = dict(fft_sizes=fft_sizes, hop_sizes=hop_sizes,
                   win_lengths=win_lengths)

    def train_step(state: TrainState, batch):
        wav, mel = batch["wav"], batch["mel"]
        g_opt = state.optimizers["generator"]
        d_opt = state.optimizers["discriminator"]
        noise = torch.randn((*wav.shape, 1), generator=state.rng,
                            device=wav.device, dtype=wav.dtype)
        disc_on = state.step >= discriminator_train_start_steps
        masks_from = state.rng.get_state()

        # ---------------- generator update ----------------
        gen_loss, (sc_loss, mag_loss, adv_loss) = generator_objective(
            generator, discriminator, noise, mel, wav,
            lambda_adv=lambda_adv, disc_on=disc_on, stft_kw=stft_kw,
            rng=state.rng)
        g_opt.zero_grad()
        gen_loss.backward()
        g_opt.step()

        # ---------------- discriminator update ----------------
        zero = torch.zeros((), device=wav.device)
        d_loss = real_loss = fake_loss = zero
        if disc_on:
            after = state.rng.get_state()
            state.rng.set_state(masks_from)
            with torch.no_grad():
                fake = generator(noise, mel, deterministic=False,
                                 rng=state.rng)
            state.rng.set_state(after)
            d_loss, (real_loss, fake_loss) = discriminator_objective(
                discriminator, wav, fake)
            d_opt.zero_grad()
            d_loss.backward()
            d_opt.step()

        state.step += 1
        metrics = {
            "generator_loss": gen_loss,
            "spectral_convergence_loss": sc_loss,
            "log_stft_magnitude_loss": mag_loss,
            "adversarial_loss": adv_loss,
            "discriminator_loss": d_loss,
            "real_loss": real_loss,
            "fake_loss": fake_loss,
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_pwg_eval_step(generator, discriminator, *,
                       lambda_adv: float = 4.0,
                       fft_sizes=(1024, 2048, 512),
                       hop_sizes=(120, 240, 50),
                       win_lengths=(600, 1200, 240)):
    """Loss-only evaluation step (reference: PWGEvaluator), with noise
    from a generator seeded 0 on every call, as the JAX step draws it
    from ``PRNGKey(0)``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        wav, mel = batch["wav"], batch["mel"]
        rng = torch.Generator(device=wav.device).manual_seed(0)
        noise = torch.randn((*wav.shape, 1), generator=rng,
                            device=wav.device, dtype=wav.dtype)
        fake = generator(noise, mel)
        sc_loss, mag_loss = multi_resolution_stft_loss(
            fake[..., 0], wav, fft_sizes, hop_sizes, win_lengths)
        adv_loss = _mse(discriminator(fake), 1.0)
        return {
            "generator_loss": sc_loss + mag_loss + lambda_adv * adv_loss,
            "spectral_convergence_loss": sc_loss,
            "log_stft_magnitude_loss": mag_loss,
            "adversarial_loss": adv_loss,
        }

    return eval_step
