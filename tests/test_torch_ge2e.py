"""The GE2E speaker encoder of the PyTorch port against the JAX package:
the embeddings, the similarity matrix, the loss and its accuracy, every
gradient after the (w, b) scaling, the updater's parameters after 1 and 3
Adam steps, the host-side helpers bit for bit (EER, partial windows, the
utterance embedding's mean, the recipe's sampler), the bridge's round
trip of a train state and the step's FLOP count.

Weights are drawn with numpy into the flax tree and loaded into the port
through the bridge; inputs come from numpy seeds.  Small widths: 8 mel
bands, 2 layers of 16, a 16-wide embedding, 3 speakers x 4 utterances of
12 frames.  float32 tolerances: outputs within 1e-5 of their range,
gradients within 1e-4 relative L2 of each leaf's.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import lstm_speaker_encoder as jge2e
from parakeet_tpu.models.ge2e_updater import (init_ge2e_train_state as
                                              j_init_state,
                                              make_ge2e_train_step as
                                              j_train_step)
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu_torch.bridge import (_flax_leaves, flax_arrays,
                                       load_flax_params, load_train_state,
                                       train_state_arrays)
from parakeet_tpu_torch.models import (LSTMSpeakerEncoder, compute_eer,
                                       embed_utterance, ge2e_loss,
                                       init_ge2e_train_state,
                                       make_ge2e_train_step, partial_slices,
                                       scale_wb_gradients, similarity_matrix)
from parakeet_tpu_torch.recipes.ge2e.dump import write_synthetic_mels
from parakeet_tpu_torch.recipes.ge2e.train import MultiSpeakerSampler
from parakeet_tpu_torch.training import build_optimizer
from parakeet_tpu_torch.utils.flops import ge2e_train_flops
from test_torch_speedyspeech import _close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(n_mels=8, num_layers=2, hidden_size=16, output_size=16)
N_SPK, N_UTT, FRAMES = 3, 4, 12
LR = 1e-3
# the similarity bias adds to every logit of the softmax: its true
# gradient is 0
ZERO_GRAD_KEY = "params::similarity_bias"


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N_SPK * N_UTT, FRAMES,
                                CFG["n_mels"])).astype(np.float32)


def _pair(seed=0):
    """(JAX model, its variables, the port model with the same weights,
    the flat tree).  The scale is (3, -1), not the initial (10, -5), so
    that neither term hides the other."""
    jm = jge2e.LSTMSpeakerEncoder(**CFG)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, FRAMES, CFG["n_mels"])))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, a in flatten_tree(v).items():
        leaf = key.split("::")[-1]
        if leaf == "similarity_weight":
            flat[key] = np.asarray(3.0, np.float32)
        elif leaf == "similarity_bias":
            flat[key] = np.asarray(-1.0, np.float32)
        elif leaf == "bias":
            flat[key] = (0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        else:
            flat[key] = (rng.standard_normal(a.shape)
                         / np.sqrt(a.shape[0])).astype(np.float32)
    tm = LSTMSpeakerEncoder(**CFG)
    load_flax_params(tm, flat)
    return jm, nest_flat(flat), tm, flat


def _hits(metrics):
    """The utterances the accuracy counts as right (its float32 mean may
    round differently in the two packages)."""
    return round(float(metrics["accuracy"]) * N_SPK * N_UTT)


def _jax_loss_fn(jm, x):
    def loss_fn(params):
        embeds, (w, b) = jm.apply({"params": params}, x, N_SPK,
                                  method=jge2e.LSTMSpeakerEncoder.
                                  embed_sequences)
        return jge2e.ge2e_loss(embeds, w, b)
    return loss_fn


def test_encoder_embeddings_match_jax():
    jm, v, tm, _ = _pair()
    x = _batch(1)
    want = jm.apply(v, jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach()
    _close(got, want, what="embeddings")
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_similarity_matrix_matches_jax():
    e = np.random.default_rng(2).standard_normal((N_SPK, N_UTT, 16))
    e = (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)
    _close(similarity_matrix(torch.from_numpy(e)),
           jge2e.similarity_matrix(jnp.asarray(e)), what="sim")


def test_loss_and_accuracy_match_jax():
    """The loss within 1e-6 relative and the accuracy's count equal, on a
    batch
    whose speakers differ (a mean per speaker) so that it is neither 0
    nor 1."""
    jm, v, tm, _ = _pair()
    x = _batch(3) + 0.3 * np.repeat(np.random.default_rng(4).standard_normal(
        (N_SPK, 1, 1, CFG["n_mels"])), N_UTT, 1).reshape(
            N_SPK * N_UTT, 1, CFG["n_mels"]).astype(np.float32)
    want, wm = _jax_loss_fn(jm, jnp.asarray(x))(v["params"])
    embeds, (w, b) = tm.embed_sequences(torch.from_numpy(x), N_SPK)
    got, gm = ge2e_loss(embeds, w, b)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert _hits(gm) == _hits(wm)
    assert 0 < _hits(gm) < N_SPK * N_UTT
    _close(gm["sim"].detach(), wm["sim"], what="scaled sim")


def _grads(tm):
    return {key: conv(t.grad.numpy()) for key, _, t, conv
            in _flax_leaves(tm) if key.startswith("params::")}


def test_gradients_after_wb_scaling_match_jax():
    """Every leaf's gradient, the scale's after ``scale_wb_gradients``
    (x0.01), within 1e-4 relative L2 of JAX's; but the bias b's, whose
    true gradient is 0 (b adds to every logit of a softmax), held in both
    packages to 1e-7 of the largest gradient of any leaf."""
    jm, v, tm, _ = _pair()
    x = _batch(5)
    grads = jax.grad(lambda p: _jax_loss_fn(jm, jnp.asarray(x))(p)[0])(
        v["params"])
    want = flatten_tree({"params": jge2e.scale_wb_gradients(grads)})
    embeds, (w, b) = tm.embed_sequences(torch.from_numpy(x), N_SPK)
    ge2e_loss(embeds, w, b)[0].backward()
    unscaled = tm.similarity_weight.grad.clone()
    scale_wb_gradients(tm)
    assert torch.equal(tm.similarity_weight.grad, unscaled * 0.01)
    got = _grads(tm)
    assert got.keys() == want.keys()
    largest = max(np.abs(g).max() for g in want.values())
    for key, g in want.items():
        g = np.asarray(g, np.float64)
        if key == ZERO_GRAD_KEY:
            assert max(abs(float(g)), abs(float(got[key]))) <= \
                1e-7 * largest
            continue
        rel = np.linalg.norm(got[key] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (key, rel)


@pytest.mark.parametrize("steps", [1, 3])
def test_updater_matches_jax(steps):
    """``steps`` Adam steps (lr 1e-3) of the port's updater against
    ``make_ge2e_train_step(jit=False)`` on the same batches: the losses
    within 1e-5 relative, the accuracies' counts equal, the parameters after
    within 1e-5 of each leaf's range (``_hold_params``)."""
    jm, v, tm, flat = _pair(seed=6)
    tx = jbuild("adam", LR)
    jstate = j_init_state(jm, tx, jax.random.PRNGKey(0),
                          {"utterances": jnp.zeros((N_SPK * N_UTT, FRAMES,
                                                    CFG["n_mels"]))},
                          N_SPK)
    jstate = jstate.replace(params=v["params"],
                            opt_state=tx.init(v["params"]))
    jstep = j_train_step(jm, tx, N_SPK, jit=False)
    opt = build_optimizer(tm.parameters(), "adam", LR)
    tstate = init_ge2e_train_state(tm, opt)
    tstep = make_ge2e_train_step(tm, opt, N_SPK)
    for i in range(steps):
        x = _batch(10 + i)
        jstate, want = jstep(jstate, {"utterances": jnp.asarray(x)})
        tstate, got = tstep(tstate, {"utterances": torch.from_numpy(x)})
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        assert _hits(got) == _hits(want)
    assert tstate.step == steps == int(jstate.step)
    _hold_params(tm, jstate, flat)


def _hold_params(tm, jstate, before):
    """The port's parameters against JAX's within 1e-5 of each leaf's
    range, each moved; but b, whose gradient is rounding noise (it shifts
    every logit alike; ``test_gradients_after_wb_scaling_match_jax`` holds
    it under 1e-7 of the largest), is not held: Adam moves it by about lr
    a step in the direction of that noise, in either package."""
    mine = flax_arrays(tm)
    after = flatten_tree({"params": jstate.params})
    assert mine.keys() == after.keys()
    for key, a in after.items():
        if key == ZERO_GRAD_KEY:
            assert np.isfinite(mine[key]).all()
            continue
        assert not np.array_equal(mine[key], before[key]), key
        _close(mine[key], a, what=key)


def test_compute_eer_and_partial_slices_are_the_jax_packages():
    rng = np.random.default_rng(7)
    for n, m in ((3, 4), (5, 2)):
        sim = rng.uniform(-1, 1, (n, m, n)).astype(np.float32)
        sim[np.arange(n), :, np.arange(n)] += 0.5
        assert compute_eer(sim, n) == jge2e.compute_eer(sim, n)
    for n_frames in (10, 160, 161, 239, 240, 241, 500, 1000):
        for frames, hop in ((160, 80), (40, 20), (40, 40)):
            assert partial_slices(n_frames, frames, hop) == \
                jge2e.partial_slices(n_frames, frames, hop)


@pytest.mark.parametrize("n_frames", [25, 40, 97])
def test_embed_utterance_is_the_jax_packages(n_frames):
    """The partial windows, the mean and its normalisation bit for bit,
    with one numpy function embedding the partials for both; then the
    real encoders within 1e-5."""
    mel = np.random.default_rng(n_frames).standard_normal(
        (n_frames, CFG["n_mels"])).astype(np.float32)
    proj = np.random.default_rng(8).standard_normal(
        (40 * CFG["n_mels"], 16)).astype(np.float32)

    def embed(x):
        x = np.asarray(x)
        return np.tanh(x.reshape(x.shape[0], -1) @ proj)

    jm, v, tm, _ = _pair()
    want = jge2e.embed_utterance(jm, v["params"], mel, partial_frames=40,
                                 hop=20, embed_fn=lambda p, x: embed(x))
    got = embed_utterance(tm, mel, partial_frames=40, hop=20,
                          embed_fn=lambda x: torch.from_numpy(
                              embed(x.numpy())))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    want = jge2e.embed_utterance(jm, v["params"], mel, partial_frames=40,
                                 hop=20)
    got = embed_utterance(tm, mel, partial_frames=40, hop=20)
    _close(got, want, what="embedding")


def _jax_recipe(name):
    """The JAX recipe script ``recipes/<name>`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_recipe_{name.replace('/', '_')[:-3]}", ROOT / "recipes" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sampler_draws_the_jax_recipes_batches(tmp_path):
    """``MultiSpeakerSampler``'s first 3 batches bit for bit, with
    speakers of fewer and of more utterances than a batch takes and mels
    shorter than a crop."""
    root = write_synthetic_mels(tmp_path / "mels", seed=9, speakers=5,
                                utterances=3, frames=(8, 30), n_mels=4)
    jax_sampler = _jax_recipe("ge2e/train.py").MultiSpeakerSampler(
        root, 3, 4, 16, seed=2)
    port = MultiSpeakerSampler(root, 3, 4, 16, seed=2)
    for _ in range(3):
        want, got = jax_sampler.batch(), port.batch()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="speakers"):
        MultiSpeakerSampler(root, 6, 2, 16)


def test_bridge_round_trip_of_a_train_state():
    """A JAX GE2E train state after one step (Adam's moments of every
    leaf, the 0-d scale's too) loads into the port's state, which writes
    it back bit for bit; the port's step from it equals JAX's next."""
    jm, v, tm, _ = _pair(seed=11)
    tx = jbuild("adam", LR)
    jstate = j_init_state(jm, tx, jax.random.PRNGKey(0),
                          {"utterances": jnp.asarray(_batch(12))}, N_SPK)
    jstep = j_train_step(jm, tx, N_SPK, jit=False)
    jstate, _ = jstep(jstate, {"utterances": jnp.asarray(_batch(13))})
    jflat = {k: np.asarray(a) for k, a in flatten_tree(jstate).items()
             if k != "rng"}
    tstate = init_ge2e_train_state(
        tm, build_optimizer(tm.parameters(), "adam", LR))
    load_train_state(tstate, jflat)
    back = train_state_arrays(tstate)
    assert back.keys() == jflat.keys()
    for key, a in jflat.items():
        assert np.array_equal(back[key], a), key
    assert back["params::similarity_weight"].shape == ()
    x = _batch(14)
    jstate, want = jstep(jstate, {"utterances": jnp.asarray(x)})
    tstate, got = make_ge2e_train_step(tm, tstate.optimizers["model"],
                                       N_SPK)(tstate,
                                              {"utterances":
                                               torch.from_numpy(x)})
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    _hold_params(tm, jstate, jflat)


def test_ge2e_train_flops_by_hand_and_by_the_products():
    """``ge2e_train_flops`` at the bench's shape by hand (0.277 TFLOP
    forward, 3x that a step), and its forward at a small shape against
    ``FlopCounterMode`` over an explicit cell loop (the products of
    ``torch.lstm``, which the counter does not see inside)."""
    per_frame = 2 * 4 * 256 * (40 + 256) + 2 * (2 * 4 * 256 * (256 + 256))
    forward = 640 * (160 * per_frame + 2 * 256 * 256)
    assert ge2e_train_flops(640, 160) == 3 * forward
    assert ge2e_train_flops(640, 160, backward=False) == forward
    assert round(forward / 1e12, 3) == 0.277
    from torch.utils.flop_counter import FlopCounterMode
    tm = LSTMSpeakerEncoder(**CFG)
    x = torch.from_numpy(_batch(15))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        h = x
        for i in range(CFG["num_layers"]):
            cell = getattr(tm, f"lstm_{i}").cell
            state = cell.zero_state(h.shape[0], h)
            outs = []
            for t in range(h.shape[1]):
                gates = (torch.nn.functional.linear(h[:, t], cell.weight_ih)
                         + torch.nn.functional.linear(state[0],
                                                      cell.weight_hh))
                i_, f_, g_, o_ = gates.chunk(4, -1)
                c = (torch.sigmoid(f_) * state[1]
                     + torch.sigmoid(i_) * torch.tanh(g_))
                state = (torch.sigmoid(o_) * torch.tanh(c), c)
                outs.append(state[0])
            h = torch.stack(outs, 1)
        tm.linear(h[:, -1])
    assert counter.get_total_flops() == ge2e_train_flops(
        N_SPK * N_UTT, FRAMES, backward=False, **CFG)
