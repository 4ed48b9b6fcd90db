"""WaveFlow of the PyTorch port against the JAX package: fold/unfold, the
polyphase ``UpsampleNet`` at odd and even factors, the density forward
``(z, logs_sum)`` and ``inverse`` (the row sampler) at n_group 16 and 32
(height dilation) with nonzero output projections, bf16 sampling against
float32 and against JAX's float32-accumulating bf16 sampler,
``waveflow_loss``, one Adam train step whose state crosses the
bridge both ways, and the recipe's ``WaveFlowClip``.

Weights are drawn with numpy into the flax tree and loaded into the port
through the bridge; inputs come from numpy seeds.  The output
projections are drawn like every other kernel (a fresh model's are zero,
which makes every flow the identity and proves nothing).  float32
outputs are held within 1e-5 of their range, the sampler's within 1e-4
(eight inverted flows amplify rounding through exp(-logs)).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import waveflow as jwf
from parakeet_tpu.models.waveflow_updater import make_waveflow_train_step \
    as j_train_step
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.state import TrainState as JTrainState
from parakeet_tpu_torch.bridge import (RNG_KEY, _flax_leaves, flax_arrays,
                                       load_flax_params, load_train_state,
                                       train_state_arrays)
from parakeet_tpu_torch.models import (ConditionalWaveFlow, UpsampleNet,
                                       fold, init_waveflow_,
                                       init_waveflow_train_state,
                                       make_waveflow_eval_step,
                                       make_waveflow_train_step, unfold,
                                       waveflow_loss)
from parakeet_tpu_torch.models import waveflow as twf
from parakeet_tpu_torch.models.waveflow import fold_condition
from parakeet_tpu_torch.recipes.waveflow.train import WaveFlowClip
from parakeet_tpu_torch.training import build_optimizer
from test_torch_speedyspeech import LR, _close, _randomize

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(upsample_factors=(4, 4), n_flows=4, n_layers=3, n_group=16,
           channels=8, n_mels=6)


def _tree(module, seed, *args, method=None):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, method=method),
                            jax.random.PRNGKey(seed))
    return _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), seed)


def _pair(seed=0, frames=5, **kw):
    """(JAX model, port model with the same weights, the flat tree, audio,
    mel)."""
    cfg = {**CFG, **kw}
    rng = np.random.default_rng(seed + 1)
    hop = int(np.prod(cfg["upsample_factors"]))
    mel = rng.standard_normal((2, frames, cfg["n_mels"])).astype(np.float32)
    audio = (0.3 * rng.standard_normal((2, frames * hop))).astype(np.float32)
    jm = jwf.ConditionalWaveFlow(**cfg)
    flat = _tree(jm, seed, jnp.asarray(audio), jnp.asarray(mel))
    tm = ConditionalWaveFlow(**cfg)
    load_flax_params(tm, flat)          # raises on anything unmapped
    return jm, tm, flat, audio, mel


def test_fold_unfold_and_condition_match_jax():
    """``fold`` (a tail shorter than a column dropped), ``unfold`` and
    ``fold_condition`` against JAX's, bitwise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 70)).astype(np.float32)
    c = rng.standard_normal((2, 70, 3)).astype(np.float32)
    got = fold(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwf.fold(
        jnp.asarray(x), 8)))
    np.testing.assert_array_equal(unfold(got).numpy(), x[:, :64])
    np.testing.assert_array_equal(
        fold_condition(torch.from_numpy(c), 8).numpy(),
        np.asarray(jwf.fold_condition(jnp.asarray(c), 8)))


@pytest.mark.parametrize("factors", [(3,), (4,), (5, 2), (16, 16)])
def test_upsample_net_matches_jax_and_round_trips(factors):
    """The polyphase upsampler at odd and even factors against JAX's
    within 1e-5 of the range; its raw flax parameters come back from the
    port bitwise."""
    rng = np.random.default_rng(sum(factors))
    mel = rng.standard_normal((2, 7, 5)).astype(np.float32)
    jnet = jwf.UpsampleNet(upsample_factors=factors)
    flat = _tree(jnet, 2, jnp.asarray(mel))
    want = jnet.apply(nest_flat(flat), jnp.asarray(mel))
    net = UpsampleNet(factors)
    load_flax_params(net, flat)
    got = net(torch.from_numpy(mel))
    assert got.shape == (2, 7 * int(np.prod(factors)), 5)
    _close(got.detach(), want, what="upsampled")
    back = flax_arrays(net)
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


@pytest.mark.parametrize("n_group", [16, 32])
def test_density_forward_and_inverse_match_jax(n_group):
    """The density forward's (z, logs_sum) within 1e-5 of their range,
    and the sampler (``decoder.inverse``, one row a step through each
    layer's carried rows; height dilations 1, 2, 4 at n_group 32) on the
    same z within 1e-4, with every output projection nonzero; the
    sampler inverts the port's own forward within 1e-4; ``infer`` with
    the noise passed in is the inverse of sigma x noise."""
    jm, tm, flat, audio, mel = _pair(seed=n_group, n_group=n_group,
                                     frames=8)
    v = nest_flat(flat)
    assert np.abs(flat["params::decoder::flows_0::output_proj::kernel"]
                  ).max() > 0.1
    want_z, want_logs = jm.apply(v, jnp.asarray(audio), jnp.asarray(mel))
    z, logs = tm(torch.from_numpy(audio), torch.from_numpy(mel))
    _close(z.detach(), want_z, what="z")
    _close(logs.detach(), want_logs, what="logs_sum")
    cond = jm.apply(v, jnp.asarray(mel), method=lambda m, x: m.encoder(x))
    want_x = jm.apply(v, want_z, cond[:, :z.shape[1]],
                      method=lambda m, z, c: m.decoder.inverse(z, c))
    with torch.no_grad():
        tcond = tm.encoder(torch.from_numpy(mel))[:, :z.shape[1]]
        x = tm.decoder.inverse(torch.from_numpy(np.array(want_z)), tcond)
        again = tm.decoder.inverse(z, tcond)
        noise = torch.from_numpy(np.array(want_z))
        wav = tm.infer(torch.from_numpy(mel), noise=noise)
    _close(x, want_x, rel=1e-4, what="inverse")
    _close(again, audio[:, :z.shape[1]], rel=1e-4, what="round trip")
    assert torch.equal(wav, x)
    assert abs(float(logs.detach().sum())) > 1e-2      # not the identity


def test_bf16_sampling_close_to_float32():
    """``sample_act_dtype=torch.bfloat16`` against the float32 sampler on
    the same z and condition, within the JAX test's bound (0.05 absolute,
    tests/test_vocoder_speaker.py): bf16 rounding of the net amplified
    through the flows."""
    _, tm, flat, audio, mel = _pair(seed=5, frames=8)
    fast = ConditionalWaveFlow(**CFG, sample_act_dtype=torch.bfloat16)
    load_flax_params(fast, flat)
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8 * 16)).astype(np.float32))
    with torch.no_grad():
        x32 = tm.infer(torch.from_numpy(mel), noise=z)
        x16 = fast.infer(torch.from_numpy(mel), noise=z)
    assert x16.dtype == torch.float32 and torch.isfinite(x16).all()
    assert (x16 - x32).abs().max().item() <= 0.05
    assert not torch.equal(x16, x32)


@pytest.mark.parametrize("n_group", [16, 32])
def test_bf16_sampling_accumulates_in_float32_as_jax(n_group, monkeypatch):
    """The bf16 sampler against JAX's (``sample_act_dtype=jnp.bfloat16``,
    whose tap products and output projections accumulate and return
    float32) on the same z and condition, within 1e-4 of the range.  The
    bound tells the two semantics apart: with each product rounded to
    bf16 before it is summed, the same sampler misses it."""
    jm, _, flat, _, mel = _pair(seed=n_group + 1, frames=8, n_group=n_group)
    v = nest_flat(flat)
    jfast = jwf.ConditionalWaveFlow(**{**CFG, "n_group": n_group},
                                    sample_act_dtype=jnp.bfloat16)
    z = np.random.default_rng(3).standard_normal((2, 8 * 16)).astype(
        np.float32)
    cond = jm.apply(v, jnp.asarray(mel), method=lambda m, x: m.encoder(x))
    want = jfast.apply(v, jnp.asarray(z), cond[:, :z.shape[1]],
                       method=lambda m, z, c: m.decoder.inverse(z, c))
    fast = ConditionalWaveFlow(**{**CFG, "n_group": n_group},
                               sample_act_dtype=torch.bfloat16)
    load_flax_params(fast, flat)
    with torch.no_grad():
        tcond = fast.encoder(torch.from_numpy(mel))[:, :z.shape[1]]
        got = fast.decoder.inverse(torch.from_numpy(z), tcond)
        monkeypatch.setattr(twf, "mm_f32", lambda a, b: (a @ b).float())
        rounded = fast.decoder.inverse(torch.from_numpy(z), tcond)
    _close(got, want, rel=1e-4, what="bf16 sampler")
    with pytest.raises(AssertionError):
        _close(rounded, want, rel=1e-4, what="products rounded to bf16")


def test_loss_and_train_step_match_jax_and_the_state_crosses():
    """``waveflow_loss`` and one Adam step (lr 1e-3) of the port's updater
    against the JAX updater's from the same weights and batch: every loss
    within 1e-5 relative, each gradient within 1e-4 relative L2 of
    ``jax.grad``'s, the parameters after the step within 1e-5 of each
    leaf's range (an element whose gradient is below 1e-3 of its leaf's
    largest may move by lr).  The state crosses under the JAX
    TrainState's keys: Adam moments within 1e-4 of each leaf's range,
    JAX's state loaded into a fresh port state comes back bitwise."""
    jm, tm, flat, audio, mel = _pair(seed=11)
    batch = {"wav": audio, "mel": mel}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    v = nest_flat(flat)
    tx = jbuild("adam", LR)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        opt_state=tx.init(v["params"]),
                        rng=jax.random.PRNGKey(0))
    step = j_train_step(jm, tx, jit=False)
    new_state, want = jax.jit(lambda st: step(st, jbatch))(state)
    grads = jax.jit(jax.grad(lambda p: jwf.waveflow_loss(*jm.apply(
        {"params": p}, jbatch["wav"], jbatch["mel"]))["loss"]))(v["params"])
    opt = build_optimizer(tm.parameters(), "adam", LR)
    tstate = init_waveflow_train_state(tm, opt,
                                       torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    eval_loss = make_waveflow_eval_step(tm)(None, tb)
    np.testing.assert_allclose(eval_loss["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    tstate, got = make_waveflow_train_step(tm, opt)(tstate, tb)
    assert tstate.step == 1 and got.keys() == {*want, "batch_size"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    jax_g = flatten_tree({"params": grads})
    mine_g = {key: conv(t.grad.numpy()) for key, _, t, conv
              in _flax_leaves(tm)}
    after = flatten_tree({"params": new_state.params})
    mine = flax_arrays(tm)
    assert mine.keys() == after.keys() == jax_g.keys()
    for key, g in jax_g.items():
        g = np.asarray(g, np.float64)
        rel = np.linalg.norm(mine_g[key] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (key, rel)
        sure = np.abs(g) >= 1e-3 * np.abs(g).max()
        _close(mine[key][sure], np.asarray(after[key])[sure], what=key)
        assert (np.abs(mine[key] - flat[key])[~sure] <= LR * 1.001).all()
    want_flat = flatten_tree(new_state)
    got_flat = train_state_arrays(tstate)
    assert set(got_flat) - {RNG_KEY} == set(want_flat) - {"rng"}
    for key, value in want_flat.items():
        if key.startswith("opt_state::"):
            _close(got_flat[key], value, rel=1e-4, what=key)
    fresh = ConditionalWaveFlow(**CFG)
    fresh_state = init_waveflow_train_state(
        fresh, build_optimizer(fresh.parameters(), "adam", LR),
        torch.Generator().manual_seed(0))
    load_train_state(fresh_state, {k: np.asarray(x)
                                   for k, x in want_flat.items()})
    back = train_state_arrays(fresh_state)
    for key, value in want_flat.items():
        if key != "rng":
            np.testing.assert_array_equal(back[key], np.asarray(value),
                                          err_msg=key)


def test_init_is_the_identity_flow():
    """``init_waveflow_``: zero output projections, so a fresh model's z
    is its audio and logs_sum is 0; the upsampler's raw kernels drawn."""
    model = ConditionalWaveFlow(**CFG)
    init_waveflow_(model, torch.Generator().manual_seed(0))
    assert model.encoder.deconv_0_kernel.abs().max() > 0
    audio = torch.randn(2, 80)
    z, logs = model(audio, torch.randn(2, 5, 6))
    assert torch.equal(logs, torch.zeros(2))
    assert torch.equal(z, audio)
    loss = waveflow_loss(z, logs)
    assert torch.isfinite(loss["loss"])


def _jax_recipe_clip():
    path = ROOT / "recipes" / "waveflow" / "train.py"
    spec = importlib.util.spec_from_file_location("_jax_wf_recipe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.WaveFlowClip


def test_waveflow_clip_matches_the_jax_recipe():
    """``WaveFlowClip`` against the JAX recipe's for the same seed,
    bitwise, over an epoch of batches (utterances longer and shorter than
    the clip); epoch 1 reseeds from (seed, 1) and repeats itself."""
    rng = np.random.default_rng(4)
    examples = []
    for frames in (20, 9, 33, 12, 7):
        examples.append({"wave": rng.standard_normal(frames * 16 - 5),
                         "feats": rng.standard_normal((frames, 6))})
    mine, theirs = WaveFlowClip(10, 16, seed=7), _jax_recipe_clip()(10, 16, 7)
    for batch in (examples[:3], examples[3:], examples):
        got, want = mine(batch), theirs(batch)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["wav"].shape == (5, 160) and got["mel"].shape == (5, 10, 6)
    mine.set_epoch(1)
    first = mine(examples)
    mine.set_epoch(1)
    np.testing.assert_array_equal(mine(examples)["wav"], first["wav"])
