"""Tacotron2 of the PyTorch port against the JAX package: the LSTM bridge,
location-sensitive attention, the model teacher-forced and free-running,
the loss, one Adam train step and the recipe's batch function.

Weights are drawn with numpy into the flax tree and loaded into the port
through the bridge; inputs come from numpy seeds.  Every dropout rate is
0 (JAX's and torch's random streams differ), the prenet's included;
the prenet's masks are checked against its own draws instead.  Decodes
are short (<= 20 steps) so that float32 differences do not grow.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from parakeet_tpu.models.tacotron2 import Tacotron2 as JT2
from parakeet_tpu.models.tacotron2 import tacotron2_loss as j_loss
from parakeet_tpu.models.tacotron2_updater import make_tacotron2_train_step
from parakeet_tpu.nn.attention import LocationSensitiveAttention as JLSA
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.state import TrainState as JTrainState
from parakeet_tpu_torch.bridge import (RNG_KEY, flax_arrays,
                                       load_flax_params, load_train_state,
                                       train_state_arrays)
from parakeet_tpu_torch.models import (Tacotron2, init_tacotron2_,
                                       init_tacotron2_train_state,
                                       make_tacotron2_eval_step,
                                       make_tacotron2_train_step as
                                       t_train_step, tacotron2_loss)
from parakeet_tpu_torch.nn import LocationSensitiveAttention, LSTMCell
from parakeet_tpu_torch.nn.postnet import Prenet
from parakeet_tpu_torch.recipes.tacotron2.train import tacotron2_batch_fn
from parakeet_tpu_torch.training import build_optimizer
from test_torch_speedyspeech import (LR, _close, _randomize,
                                     assert_adam_step_matches)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=12, n_tones=4, d_mels=8, d_encoder=16,
           encoder_conv_layers=1, d_prenet=8, d_attention_rnn=12,
           d_decoder_rnn=12, d_attention=8, attention_filters=4,
           d_postnet=8, postnet_conv_layers=2)
NO_DROPOUT = dict.fromkeys(("p_encoder_dropout", "p_prenet_dropout",
                            "p_attention_dropout", "p_decoder_dropout",
                            "p_postnet_dropout"), 0.0)
T_TEXT, FRAMES = 9, 14
TEXT_LENGTHS = (9, 5)          # the second utterance is padded
FRAME_LENGTHS = (14, 10)


def _batch(seed):
    rng = np.random.default_rng(seed)
    text = np.zeros((2, T_TEXT), np.int64)
    tones = np.zeros((2, T_TEXT), np.int64)
    for i, n in enumerate(TEXT_LENGTHS):
        text[i, :n] = rng.integers(1, 12, n)
        tones[i, :n] = rng.integers(1, 4, n)
    return {"text": text, "tones": tones,
            "text_lengths": np.array(TEXT_LENGTHS),
            "speech": rng.standard_normal((2, FRAMES, 8)).astype(np.float32),
            "speech_lengths": np.array(FRAME_LENGTHS)}


def _jax_args(batch):
    return (jnp.asarray(batch["text"]), jnp.asarray(batch["text_lengths"]),
            jnp.asarray(batch["speech"]),
            jnp.asarray(batch["speech_lengths"]))


def _pair(seed=0, **kw):
    """(JAX model, variables, port model with the same weights, the flat
    tree, the batch)."""
    batch = _batch(seed + 1)
    jm = JT2(**CFG, **NO_DROPOUT, **kw)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k, "dropout": k}, *_jax_args(batch),
        tones=jnp.asarray(batch["tones"]), deterministic=False),
        jax.random.PRNGKey(seed))
    flat = _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), seed)
    tm = Tacotron2(**CFG, **NO_DROPOUT, **kw)
    load_flax_params(tm, flat)          # raises on anything unmapped
    return jm, nest_flat(flat), tm, flat, batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_lstm_cell_bridge_round_trip_and_step():
    """flax's ``OptimizedLSTMCell`` (eight dense layers) onto the port's
    ``LSTMCell`` and back, bitwise; one step from a non-zero carry agrees
    (flax's carry (c, h), torch's (h, c)) within 1e-6."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    c = rng.standard_normal((3, 6)).astype(np.float32)
    h = rng.standard_normal((3, 6)).astype(np.float32)
    cell = fnn.OptimizedLSTMCell(6)
    v = cell.init(jax.random.PRNGKey(0), (jnp.asarray(c), jnp.asarray(h)),
                  jnp.asarray(x))
    flat = _randomize(flatten_tree(v), 3)
    assert len(flat) == 12 and "params::ii::kernel" in flat
    tc = LSTMCell(5, 6)
    load_flax_params(tc, flat)
    assert [n for n, _ in tc.named_parameters()] == [
        "weight_ih", "weight_hh", "bias_hh"]
    back = flax_arrays(tc)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    (want_c, want_h), _ = cell.apply(nest_flat(flat), (jnp.asarray(c),
                                                       jnp.asarray(h)),
                                     jnp.asarray(x))
    got_h, got_c = tc(torch.from_numpy(x), (torch.from_numpy(h),
                                            torch.from_numpy(c)))
    _close(got_h.detach(), want_h, rel=1e-6, what="h")
    _close(got_c.detach(), want_c, rel=1e-6, what="c")
    with pytest.raises(KeyError):
        load_flax_params(tc, {k: a for k, a in flat.items()
                              if k != "params::hg::bias"})


def test_location_sensitive_attention_one_step():
    """One alignment step with masked keys: context within 1e-5 of its
    range, weights within 1e-6 and exactly 0 at the masked keys."""
    rng = np.random.default_rng(4)
    b, t = 2, 11
    q = rng.standard_normal((b, 12)).astype(np.float32)
    keys = rng.standard_normal((b, t, 16)).astype(np.float32)
    w = rng.dirichlet(np.ones(t), b).astype(np.float32)
    cum = (w + rng.random((b, t))).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[11], [6]])
    lsa = JLSA(8, 4, 31)

    def step(m, q, keys, w, cum, mask):
        return m(q, m.process_keys(keys), keys, w, cum, mask=mask)

    args = [jnp.asarray(a) for a in (q, keys, w, cum, mask)]
    v = lsa.init(jax.random.PRNGKey(0), *args, method=step)
    flat = _randomize(flatten_tree(v), 5)
    want_ctx, want_w = lsa.apply(nest_flat(flat), *args, method=step)
    tl = LocationSensitiveAttention(12, 16, 8, 4, 31)
    load_flax_params(tl, flat)
    tk = torch.from_numpy(keys)
    ctx, got_w = tl(torch.from_numpy(q), tl.process_keys(tk), tk,
                    torch.from_numpy(w), torch.from_numpy(cum),
                    torch.from_numpy(mask))
    _close(ctx.detach(), want_ctx, what="context")
    _close(got_w.detach(), want_w, rel=1e-6, what="weights")
    assert (got_w[1, 6:] == 0).all()


@pytest.mark.parametrize("deterministic", [False, True])
def test_teacher_forced_matches_jax(deterministic):
    """``__call__`` on padded text with tones: every output (mel, Postnet
    mel, stop logits, float32 alignments) within 1e-5 of its range
    everywhere, and the encoder's values at every position, padded ones
    included (the BiLSTM runs flax's flip inside each length)."""
    jm, variables, tm, _, batch = _pair()
    tones = jnp.asarray(batch["tones"])
    tb = _tb(batch)
    # the encoder first: a forward on batch statistics updates the port's
    # running statistics in place
    want_enc, _ = jm.apply(variables, jnp.asarray(batch["text"]),
                           jnp.asarray(batch["text_lengths"]), tones,
                           deterministic=deterministic,
                           mutable=["batch_stats"], method=JT2.encode)[0]
    got_enc, _ = tm.encode(tb["text"], tb["text_lengths"], tb["tones"],
                           deterministic=deterministic)
    _close(got_enc.detach(), want_enc, what="encoder values")
    want, _ = jax.jit(lambda v: jm.apply(
        v, *_jax_args(batch), tones=tones, deterministic=deterministic,
        mutable=["batch_stats"]))(variables)
    got = tm(tb["text"], tb["text_lengths"], tb["speech"],
             tb["speech_lengths"], tones=tb["tones"],
             deterministic=deterministic)
    for key in ("mel_output", "mel_outputs_postnet", "stop_logits",
                "alignments"):
        _close(got[key].detach(), want[key], what=key)
    assert got["alignments"].dtype == torch.float32
    assert (got["alignments"][1, :, TEXT_LENGTHS[1]:] == 0).all()


def _jax_infer(jm, flat, batch, steps, **kw):
    return jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["text"]), jnp.asarray(batch["text_lengths"]),
        max_decoder_steps=steps, rngs={"dropout": jax.random.PRNGKey(0)},
        method=JT2.infer, **kw))(nest_flat(flat))


def _stop_logits(tm, batch, steps):
    """The port's stop logits (B, steps) of ``infer``, by a hook."""
    logits = []
    hook = tm.cell.stop_proj.register_forward_hook(
        lambda mod, args, out: logits.append(out[..., 0].detach()))
    tb = _tb(batch)
    tm.infer(tb["text"], tb["text_lengths"], max_decoder_steps=steps)
    hook.remove()
    return torch.stack(logits, 1).numpy()


@pytest.mark.parametrize("use_stop_token", [True, False])
def test_infer_matches_jax_across_a_stop(use_stop_token):
    """``infer`` over a fixed 20 steps.  With the stop token, the stop
    projection's bias is shifted so that the first utterance's stop logit
    (rising over the steps at this seed) first crosses 0 at step 8, by a
    margin above 1e-4 on both sides: it stops inside the window, and its
    last valid frames go through the Postnet with frames made after the
    stop, which the port must make too.  Without it, the attention peak
    and a grace of 2 steps end an utterance.  Lengths equal, mels (zero
    past each length) and alignments within 1e-5 of their range."""
    steps, cross = 20, 8
    jm, _, tm, flat, batch = _pair(seed=8, use_stop_token=use_stop_token)
    kw = {} if use_stop_token else {"grace_steps": 2}
    flat = dict(flat)
    if use_stop_token:
        logits = _stop_logits(tm, batch, steps)[0]
        shift = -(logits[cross - 1] + logits[cross]) / 2
        assert logits[:cross].max() + shift < -1e-4 < 1e-4 < (
            logits[cross] + shift)
        flat["params::cell::stop_proj::bias"] = (
            flat["params::cell::stop_proj::bias"] + shift).astype(np.float32)
        load_flax_params(tm, flat)
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["text"]), jnp.asarray(batch["text_lengths"]),
        max_decoder_steps=steps, rngs={"dropout": jax.random.PRNGKey(0)},
        method=JT2.infer, **kw))(nest_flat(flat))
    tb = _tb(batch)
    got = tm.infer(tb["text"], tb["text_lengths"], max_decoder_steps=steps,
                   **kw)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    _close(got["mel_outputs_postnet"].detach(), want["mel_outputs_postnet"],
           what="mel")
    _close(got["alignments"].detach(), want["alignments"], what="align")
    n = int(got["lengths"][0])
    assert (got["mel_outputs_postnet"][0, n:] == 0).all()
    if use_stop_token:
        assert n == cross + 1
        # decoding stops at the stop: the same first n steps, but the
        # Postnet then sees zero padding where the 20-step decode had the
        # frames made after the stop, and the last valid frame changes
        short = tm.infer(tb["text"], tb["text_lengths"], max_decoder_steps=n)
        assert not torch.equal(short["mel_outputs_postnet"][0, n - 1],
                               got["mel_outputs_postnet"][0, n - 1])


def test_loss_matches_jax():
    """``tacotron2_loss`` with the stop loss (pos_weight 2) and the guided
    attention loss at reduction factor 2: every term within 1e-6
    relative."""
    rng = np.random.default_rng(8)
    batch = _batch(9)
    outputs = {"mel_output": rng.standard_normal((2, FRAMES, 8)),
               "mel_outputs_postnet": rng.standard_normal((2, FRAMES, 8)),
               "stop_logits": rng.standard_normal((2, FRAMES // 2)) * 3,
               "alignments": rng.dirichlet(np.ones(T_TEXT),
                                           (2, FRAMES // 2))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    kw = dict(use_stop_token_loss=True, use_guided_attention_loss=True,
              sigma=0.3, stop_pos_weight=2.0)
    want = j_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                  *_jax_args(batch)[2:], jnp.asarray(batch["text_lengths"]),
                  **kw)
    tb = _tb(batch)
    got = tacotron2_loss(_tb(outputs), tb["speech"], tb["speech_lengths"],
                         tb["text_lengths"], **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("updater", [
    {}, {"use_guided_attention_loss": True, "sigma": 0.3}])
def test_train_step_matches_jax(updater):
    """One Adam step (lr 1e-3) of the port's updater against the JAX
    updater's step from the same weights and batch (the recipe's
    ``updater`` keys passed to both), as ``assert_adam_step_matches``."""
    jm, variables, tm, flat, batch = _pair(seed=10)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jbuild("adam", LR)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        opt_state=tx.init(variables["params"]),
                        batch_stats=variables["batch_stats"],
                        rng=jax.random.PRNGKey(0))
    step = make_tacotron2_train_step(jm, tx, jit=False, **updater)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *_jax_args(batch), tones=jbatch["tones"],
                          deterministic=False, mutable=["batch_stats"])
        return j_loss(out, jbatch["speech"], jbatch["speech_lengths"],
                      jbatch["text_lengths"], **updater)["loss"]

    (new_state, want), grads = jax.jit(lambda st: (
        step(st, jbatch), jax.grad(loss_fn)(st.params)))(state)
    opt = build_optimizer(tm.parameters(), "adam", LR)
    tstate = init_tacotron2_train_state(tm, opt,
                                        torch.Generator().manual_seed(0))
    tstate, got = t_train_step(tm, opt, **updater)(tstate, _tb(batch))
    assert tstate.step == 1 and got["batch_size"].item() == 2.0
    assert_adam_step_matches(tm, flat, got, want, grads, new_state)
    # the train state crosses under the JAX TrainState's keys (one model:
    # its tree at the root), the LSTM cells' Adam moments gate by gate:
    # the port's against JAX's (1e-4 of each leaf's range: first moments
    # 0.1 g, second 0.001 g^2), and JAX's loaded into a fresh port state
    # comes back bitwise
    want_flat = flatten_tree(new_state)
    got_flat = train_state_arrays(tstate)
    assert set(got_flat) - {RNG_KEY} == set(want_flat) - {"rng"}
    assert "opt_state::0::mu::cell::decoder_rnn::hg::bias" in got_flat
    for key, value in want_flat.items():
        if key.startswith("opt_state::"):
            _close(got_flat[key], value, rel=1e-4, what=key)
    fresh = Tacotron2(**CFG, **NO_DROPOUT)
    fresh_state = init_tacotron2_train_state(
        fresh, build_optimizer(fresh.parameters(), "adam", LR),
        torch.Generator().manual_seed(0))
    load_train_state(fresh_state, {k: np.asarray(v)
                                   for k, v in want_flat.items()})
    back = train_state_arrays(fresh_state)
    for key, value in want_flat.items():
        if key != "rng":
            np.testing.assert_array_equal(back[key], np.asarray(value),
                                          err_msg=key)


def test_prenet_masks_equal_its_draws_and_eval_is_repeatable():
    """The prenet with the masks of ``keep_masks`` gives bitwise what it
    gives drawing them from the same generator state; always-on dropout
    drops under ``deterministic`` too; the eval step (prenet masks from a
    fixed seed) repeats itself; ``init_tacotron2_`` draws the uniform
    embedding."""
    torch.manual_seed(0)
    pre = Prenet(8, 2, 6, 0.5, always_dropout=True, use_bias=False)
    x = torch.randn(3, 5, 8)
    drawn = pre(x, rng=torch.Generator().manual_seed(7))
    keep = pre.keep_masks((3, 5), torch.Generator().manual_seed(7), "cpu")
    assert keep.shape == (2, 3, 5, 6)
    assert torch.equal(pre(x, keep=keep), drawn)
    undropped = Prenet(8, 2, 6, 0.0, use_bias=False)
    undropped.load_state_dict(pre.state_dict())
    assert not torch.equal(drawn, undropped(x))
    model = Tacotron2(**CFG)
    init_tacotron2_(model, torch.Generator().manual_seed(0))
    emb = model.embedding.weight
    assert 0.0 <= emb.min() and emb.max() < 0.1
    step = make_tacotron2_eval_step(model)
    tb = _tb(_batch(3))
    first, second = step(None, tb), step(None, tb)
    assert first.keys() == {"mel_loss", "postnet_mel_loss", "stop_loss",
                            "loss"}
    for k in first:
        assert torch.isfinite(first[k]) and torch.equal(first[k], second[k])


def _jax_recipe_batch_fn():
    path = ROOT / "recipes" / "tacotron2" / "train.py"
    spec = importlib.util.spec_from_file_location("_jax_t2_recipe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.tacotron2_batch_fn


@pytest.mark.parametrize("spk_emb", [False, True])
def test_batch_fn_matches_the_jax_recipe(spk_emb):
    """The recipe's ``tacotron2_batch_fn`` against the JAX recipe's,
    bitwise (buckets of 16 tokens and 64 frames; spk_emb stacked when the
    rows have it)."""
    rng = np.random.default_rng(12)
    examples = []
    for n, f in ((5, 70), (17, 20), (9, 64)):
        row = {"text": rng.integers(1, 30, n),
               "speech": rng.standard_normal((f, 8)).astype(np.float32)}
        if spk_emb:
            row["spk_emb"] = rng.standard_normal(6).astype(np.float32)
        examples.append(row)
    want = _jax_recipe_batch_fn()(examples)
    got = tacotron2_batch_fn(examples)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
