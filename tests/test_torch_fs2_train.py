"""FastSpeech2 training of the PyTorch port against the JAX package.

Weights are drawn with numpy and loaded into both packages through the
bridge (parameters, the Postnet's BatchNorm statistics and the scaled
positional encodings' alphas); batches are made with numpy from a seed.
Every dropout rate is 0 and the forward is not deterministic, so the
Postnet's BatchNorm runs on batch statistics, as in a train step.  The
'flash' cases run jax's Pallas kernel in interpret mode and the port's
plain K4 versions.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.models.fastspeech2 import fastspeech2_loss as j_loss
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import (FastSpeech2, fastspeech2_loss,
                                       init_fs2_train_state,
                                       make_fs2_eval_step,
                                       make_fs2_train_step)
from parakeet_tpu_torch.training import (StandardUpdater, Trainer,
                                         build_optimizer, seed_everything)

torch.set_num_threads(1)

CFG = dict(idim=20, odim=8, adim=32, aheads=2, elayers=1, eunits=48,
           dlayers=1, dunits=48, postnet_layers=2, postnet_chans=8,
           postnet_filts=5, duration_predictor_chans=16,
           pitch_predictor_chans=16, energy_predictor_chans=16,
           positionwise_layer_type="conv1d",
           positionwise_conv_kernel_size=3)
NO_DROPOUT = dict.fromkeys((
    "duration_predictor_dropout_rate", "energy_predictor_dropout",
    "energy_embed_dropout", "pitch_predictor_dropout", "pitch_embed_dropout",
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate",
    "transformer_dec_attn_dropout_rate", "postnet_dropout_rate"), 0.0)
T_TEXT, FRAMES = 12, 128
# float32 through two transformer stacks, three predictors and the Postnet
# with batch statistics, summed in other orders: 1e-4 (outputs up to ~9;
# measured <= 1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
# the running statistics after one update: measured <= 1.2e-7 apart; an
# update with the unbiased batch variance (torch.nn.BatchNorm1d's) would
# be >= 2e-5 off at these shapes (B * T = 256 frames)
STATS_TOL = dict(rtol=0, atol=2e-6)
BATCH_KEYS = ("text", "text_lengths", "speech", "speech_lengths",
              "durations", "pitch", "energy")


def _batch(text_lengths, speech_lengths, seed, odim=8):
    """Token ids, durations summing to each utterance's frames, targets."""
    rng = np.random.default_rng(seed)
    b = len(text_lengths)
    text = np.zeros((b, T_TEXT), np.int64)
    durations = np.zeros((b, T_TEXT), np.int64)
    for i, (n, f) in enumerate(zip(text_lengths, speech_lengths)):
        text[i, :n] = rng.integers(1, 20, n)
        durations[i, :n] = 1 + rng.multinomial(f - n, np.full(n, 1.0 / n))
    return {"text": text, "text_lengths": np.asarray(text_lengths),
            "speech": rng.standard_normal((b, FRAMES, odim)).astype(
                np.float32),
            "speech_lengths": np.asarray(speech_lengths),
            "durations": durations,
            "pitch": rng.standard_normal((b, T_TEXT, 1)).astype(np.float32),
            "energy": rng.standard_normal((b, T_TEXT, 1)).astype(
                np.float32)}


def _randomize(flat, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf.endswith("scale") or leaf == "var":
            v = 1.0 + 0.2 * np.abs(rng.standard_normal(a.shape))
        elif leaf.endswith("bias") or leaf in ("mean", "alpha"):
            v = 0.1 + 0.1 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    return out


def _pair(impl, seed=0):
    """(JAX model, its variables, port model with the same weights, the
    flat tree, the batch as numpy)."""
    batch = _batch((12, 9), (128, 101), seed + 1)
    jdense = JFS2(attn_impl="dense", **CFG, **NO_DROPOUT)
    v = jax.jit(lambda k: jdense.init(
        {"params": k}, *[jnp.asarray(batch[n]) for n in BATCH_KEYS],
        deterministic=False))(jax.random.PRNGKey(seed))
    flat = _randomize(flatten_tree(v), seed)
    assert {"params::encoder::pos_enc::alpha",
            "params::decoder::pos_enc::alpha",
            "batch_stats::postnet::bn_0::var"} <= set(flat)
    tm = FastSpeech2(attn_impl=impl, **CFG, **NO_DROPOUT)
    load_flax_params(tm, flat)        # raises on anything unmapped
    jm = JFS2(attn_impl=impl, **CFG, **NO_DROPOUT)
    return jm, nest_flat(flat), tm, flat, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_apply(jm, variables, batch, params=None):
    return jm.apply({"params": params if params is not None
                     else variables["params"],
                     "batch_stats": variables["batch_stats"]},
                    *[jnp.asarray(batch[k]) for k in BATCH_KEYS],
                    deterministic=False, mutable=["batch_stats"])


def _assert_stats_match(tm, mutated):
    for i in range(CFG["postnet_layers"]):
        bn = getattr(tm.postnet, f"bn_{i}")
        want = mutated["postnet"][f"bn_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(want["mean"]), **STATS_TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(want["var"]), **STATS_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_training_forward_matches_jax(impl):
    """The teacher-forced forward (JAX ``__call__``, deterministic=False)
    and the BatchNorm statistics it leaves, as flax's mutated
    ``batch_stats`` (momentum 0.99, biased batch variance)."""
    jm, variables, tm, _, batch = _pair(impl)
    want, mutated = jax.jit(lambda v: _jax_apply(jm, v, batch))(variables)
    got = tm(*[_torch_batch(batch)[k] for k in BATCH_KEYS],
             deterministic=False)
    for key in ("before_outs", "after_outs", "d_outs", "p_outs", "e_outs"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), err_msg=key, **TOL)
    np.testing.assert_array_equal(got["olens"].numpy(),
                                  np.asarray(want["olens"]))
    _assert_stats_match(tm, mutated["batch_stats"])


@pytest.mark.parametrize("use_masking,use_weighted_masking",
                         [(True, False), (False, True), (False, False)])
def test_fastspeech2_loss_matches_jax(use_masking, use_weighted_masking):
    """The loss on given outputs: masked, weighted and unmasked (float32
    sums of a few hundred terms: 1e-5)."""
    batch = _batch((12, 7), (128, 90), 3)
    rng = np.random.default_rng(4)
    outputs = {
        "before_outs": rng.standard_normal((2, FRAMES, 8)).astype(
            np.float32),
        "after_outs": rng.standard_normal((2, FRAMES, 8)).astype(np.float32),
        "d_outs": rng.standard_normal((2, T_TEXT)).astype(np.float32),
        "p_outs": rng.standard_normal((2, T_TEXT, 1)).astype(np.float32),
        "e_outs": rng.standard_normal((2, T_TEXT, 1)).astype(np.float32),
        "olens": batch["speech_lengths"]}
    want = j_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                  {k: jnp.asarray(v) for k, v in batch.items()},
                  use_masking, use_weighted_masking)
    got = fastspeech2_loss(_torch_batch(outputs), _torch_batch(batch),
                           use_masking, use_weighted_masking)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gradients_match_jax(impl):
    """Every parameter's gradient of the masked loss against ``jax.grad``,
    leaf by leaf: the JAX gradient tree goes through the bridge onto the
    port's names.  1e-3 of each gradient's range (float32 backward
    through both stacks and the Postnet's batch statistics)."""
    jm, variables, tm, flat, batch = _pair(impl, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        outputs, mutated = _jax_apply(jm, variables, batch, params)
        return j_loss(outputs, jbatch)["loss"], mutated["batch_stats"]

    (want_loss, stats), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tb = _torch_batch(batch)
    out = tm(*[tb[k] for k in BATCH_KEYS], deterministic=False)
    loss = fastspeech2_loss(out, tb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = copy.deepcopy(tm)
    load_flax_params(want, flatten_tree({"params": want_g,
                                         "batch_stats": stats}))
    wanted = dict(want.named_parameters())
    for name, p in tm.named_parameters():
        w = wanted[name].detach()
        assert p.grad is not None, name
        err = (p.grad - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-6, (name, err)
    _assert_stats_match(tm, stats)


def test_trainer_runs_three_fs2_steps(tmp_path):
    """Three Trainer steps of the port's FastSpeech2 updater with the
    default dropout rates (attention dropout 0, so 'flash' trains; its
    plain version on the CPU), masks drawn from the state's generator:
    every metric finite, every parameter and BatchNorm statistic moves,
    and the eval step is deterministic."""
    model = FastSpeech2(attn_impl="flash", transformer_enc_attn_dropout_rate=0.0,
                        transformer_dec_attn_dropout_rate=0.0, **CFG)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith(("weight", "alpha")) or p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(max(p[0].numel(), 1)))
    opt = build_optimizer(model.parameters(), "adam", learning_rate=1e-3)
    state = init_fs2_train_state(model, opt,
                                 seed_everything(0, device="cpu"))
    batches = [_torch_batch(_batch((12, 10), (128, 100 + 5 * i), 10 + i))
               for i in range(3)]
    seen = []

    def watch(trainer):
        seen.append({k: float(v) for k, v in
                     trainer.updater.last_metrics.items()})

    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s0 = {n: b.clone() for n, b in model.named_buffers()}
    updater = StandardUpdater(make_fs2_train_step(model, opt), state,
                              batches)
    Trainer(updater, stop_trigger=(3, "iteration"), out=str(tmp_path),
            extensions=[watch]).run()
    assert state.step == 3 and len(seen) == 3
    assert all(m.keys() == {"loss", "l1_loss", "duration_loss",
                            "pitch_loss", "energy_loss", "batch_size"}
               for m in seen)
    assert all(math.isfinite(v) for m in seen for v in m.values())
    assert all(m["batch_size"] == 2.0 for m in seen)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p0[n], p.detach())]
    assert sorted(moved) == sorted(p0)
    assert all(not torch.equal(s0[n], b) for n, b in model.named_buffers()
               if "running" in n)
    step = make_fs2_eval_step(model)
    first, second = step(state, batches[0]), step(state, batches[0])
    for k in first:
        assert torch.isfinite(first[k]) and torch.equal(first[k], second[k])
