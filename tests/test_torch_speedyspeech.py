"""SpeedySpeech of the PyTorch port against the JAX package: the dilated
SAME convolution, SSIM, the loss primitives, the model (teacher-forced and
free-running), one Adam train step and the batch function.

Weights are drawn with numpy into the flax tree and loaded into the port
through the bridge; inputs come from numpy seeds.  Tolerances are stated
per test (float32 forwards: about 1e-5 of each output's range).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from parakeet_tpu.data.collate import speedyspeech_batch_fn as j_batch_fn
from parakeet_tpu.models.speedyspeech import SpeedySpeech as JSS
from parakeet_tpu.models.speedyspeech import speedyspeech_loss as j_loss
from parakeet_tpu.models.speedyspeech_updater import \
    make_speedyspeech_train_step
from parakeet_tpu.ops import losses as jlosses
from parakeet_tpu.ops.ssim import ssim as j_ssim
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.state import TrainState as JTrainState
from parakeet_tpu_torch.bridge import (_flax_leaves, flax_arrays,
                                       load_flax_params)
from parakeet_tpu_torch.data import speedyspeech_batch_fn
from parakeet_tpu_torch.models import (SpeedySpeech, speedyspeech_loss,
                                       init_speedyspeech_train_state as
                                       t_init_state,
                                       make_speedyspeech_train_step as
                                       t_train_step)
from parakeet_tpu_torch.nn.conv import SameConv1d
from parakeet_tpu_torch.ops import losses as tlosses
from parakeet_tpu_torch.ops.ssim import ssim
from parakeet_tpu_torch.training import build_optimizer

torch.set_num_threads(1)

CFG = dict(vocab_size=20, encoder_hidden_size=16, encoder_kernel_size=3,
           encoder_dilations=(1, 3, 9), duration_predictor_hidden_size=16,
           decoder_hidden_size=16, decoder_output_size=8,
           decoder_kernel_size=3, decoder_dilations=(1, 3, 27),
           tone_size=5)
T_TEXT, FRAMES = 12, 48


def _close(got, want, rel=1e-5, what=""):
    """max |got - want| <= rel x the range of want (float32 sums)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    tol = rel * max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _randomize(flat, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf == "scale" or leaf == "var":
            v = 1.0 + 0.2 * np.abs(rng.standard_normal(a.shape))
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    return out


def _batch(seed, lengths=((12, 48), (7, 31))):
    """phones/tones (0 = padding), durations >= 1 summing to the frames,
    feats, as the batch function pads them."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    batch = {"phones": np.zeros((b, T_TEXT), np.int64),
             "tones": np.zeros((b, T_TEXT), np.int64),
             "durations": np.zeros((b, T_TEXT), np.int64),
             "feats": rng.standard_normal((b, FRAMES, 8)).astype(np.float32),
             "num_phones": np.array([n for n, _ in lengths]),
             "num_frames": np.array([f for _, f in lengths])}
    for i, (n, f) in enumerate(lengths):
        batch["phones"][i, :n] = rng.integers(1, 20, n)
        batch["tones"][i, :n] = rng.integers(1, 5, n)
        batch["durations"][i, :n] = 1 + rng.multinomial(
            f - n, np.full(n, 1.0 / n))
    return batch


def _pair(seed=0):
    batch = _batch(seed + 1)
    jm = JSS(**CFG)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, jnp.asarray(batch["phones"]),
        jnp.asarray(batch["durations"]), tones=jnp.asarray(batch["tones"]),
        max_frames=FRAMES, deterministic=False), jax.random.PRNGKey(seed))
    flat = _randomize(flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), seed)
    tm = SpeedySpeech(**CFG)
    load_flax_params(tm, flat)          # raises on anything unmapped
    return jm, nest_flat(flat), tm, flat, batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("kernel,dilation", [(3, 1), (3, 3), (3, 27),
                                             (4, 1), (5, 3)])
def test_same_conv_matches_flax(kernel, dilation):
    """``SameConv1d`` against flax's SAME ``nn.Conv`` with
    ``kernel_dilation``: (k - 1) d frames of padding, the odd one on the
    right (kernel 4: 1 left, 2 right); 1e-5 of the range."""
    rng = np.random.default_rng(kernel * 100 + dilation)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    conv = fnn.Conv(5, (kernel,), kernel_dilation=(dilation,),
                    padding="SAME")
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(v, jnp.asarray(x))
    tc = SameConv1d(6, 5, kernel, dilation=dilation)
    load_flax_params(tc, flatten_tree(v))
    _close(tc(torch.from_numpy(x)).detach().numpy(), want,
           what=f"k{kernel} d{dilation}")


def test_same_conv_default_dilation_is_unchanged():
    """Without ``dilation`` the convolution is bitwise the undilated
    F.conv1d on the flax padding ((k - 1) // 2 left, k // 2 right)."""
    torch.manual_seed(0)
    conv = SameConv1d(3, 4, 4)
    x = torch.randn(2, 17, 3)
    want = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.transpose(1, 2), (1, 2)), conv.weight,
        conv.bias).transpose(1, 2)
    assert torch.equal(conv(x), want)


def test_ssim_matches_jax():
    """SSIM of masked mel images (B, 1, T, C), 11 x 11 window: 1e-6."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 1, 37, 8)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    want = float(j_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = ssim(torch.from_numpy(a), torch.from_numpy(b)).item()
    assert abs(got - want) <= 1e-6, (got, want)
    # bf16 inputs are computed in float32
    assert ssim(torch.from_numpy(a).bfloat16(),
                torch.from_numpy(b).bfloat16()).dtype == torch.float32


def _loss_cases():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    y = rng.standard_normal((3, 7, 4)).astype(np.float32)
    mask = (rng.random((3, 7, 1)) > 0.3).astype(np.float32)
    logits = rng.standard_normal((3, 9)).astype(np.float32) * 3
    labels = (rng.random((3, 9)) > 0.7).astype(np.float32)
    smask = (rng.random((3, 9)) > 0.2).astype(np.float32)
    attn = rng.random((3, 9, 7)).astype(np.float32)
    dec = np.array([9, 6, 4])
    enc = np.array([7, 5, 2])
    return {
        "weighted_mean": ("weighted_mean", (x, mask), {}),
        "masked_l1_loss": ("masked_l1_loss", (x, y, mask), {}),
        "stop_token_bce": ("stop_token_bce", (logits, labels, smask),
                           {"pos_weight": 3.0}),
        "stop_token_bce_unmasked": ("stop_token_bce", (logits, labels), {}),
        "attention_guide": ("attention_guide", (dec, enc, 9, 7, 0.2), {}),
        "guided_attention_loss": ("guided_attention_loss",
                                  (attn, dec, enc, 0.2), {}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_primitives_match_jax(case):
    """Each loss of ``ops/losses.py`` on the same arrays: 1e-6 relative."""
    name, args, kw = _loss_cases()[case]
    want = getattr(jlosses, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    got = getattr(tlosses, name)(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("deterministic", [False, True])
def test_teacher_forced_forward_matches_jax(deterministic):
    """``SpeedySpeech.__call__`` (padded phones, tones, durations): mel,
    log durations and frame lengths within 1e-5 of each output's range,
    and, with batch statistics, the running BatchNorm statistics flax
    leaves (momentum 0.99, biased variance) within 2e-6."""
    jm, variables, tm, _, batch = _pair()
    args = [jnp.asarray(batch["phones"]), jnp.asarray(batch["durations"])]
    want, mutated = jax.jit(lambda v: jm.apply(
        v, *args, tones=jnp.asarray(batch["tones"]), max_frames=FRAMES,
        deterministic=deterministic, mutable=["batch_stats"]))(variables)
    tb = _tb(batch)
    got = tm(tb["phones"], tb["durations"], tones=tb["tones"],
             max_frames=FRAMES, deterministic=deterministic)
    _close(got["mel"].detach(), want["mel"], what="mel")
    _close(got["log_durations"].detach(), want["log_durations"],
           what="log_durations")
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.asarray(want["frame_lengths"]))
    stats = flax_arrays(tm)
    for key, value in flatten_tree(
            {"batch_stats": mutated["batch_stats"]}).items():
        np.testing.assert_allclose(stats[key], value, rtol=0, atol=2e-6,
                                   err_msg=key)


def test_inference_matches_jax():
    """``inference`` with the network's own durations: mel and frame
    lengths (the rounded durations must agree exactly)."""
    jm, variables, tm, _, batch = _pair(seed=4)
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["phones"]), tones=jnp.asarray(batch["tones"]),
        max_frames=64, method=JSS.inference))(variables)
    tb = _tb(batch)
    got = tm.inference(tb["phones"], tones=tb["tones"], max_frames=64)
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.asarray(want["frame_lengths"]))
    _close(got["mel"].detach(), want["mel"], what="mel")


@pytest.mark.parametrize("alpha,per_token", [(1.0, 2), (3.0, 8)])
def test_inference_rounds_half_to_even(alpha, per_token):
    """A duration head that gives exp(log_d) = 2.5 exactly (zero kernel,
    bias log 2.5 rounded to float32): alpha 1 rounds 2.5 to 2 and alpha 3
    rounds 7.5 to 8, as ``jnp.round``; the frames agree with JAX's."""
    jm, variables, tm, flat, batch = _pair(seed=6)
    bias = np.float32(np.log(2.5))
    assert float(jnp.exp(jnp.float32(bias))) == 2.5
    assert torch.exp(torch.tensor(bias)).item() == 2.5
    flat = dict(flat)
    flat["params::duration_predictor::fc::kernel"] = np.zeros_like(
        flat["params::duration_predictor::fc::kernel"])
    flat["params::duration_predictor::fc::bias"] = np.full((1,), bias,
                                                           np.float32)
    load_flax_params(tm, flat)
    max_frames = 200
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["phones"]), tones=jnp.asarray(batch["tones"]),
        max_frames=max_frames, alpha=alpha,
        method=JSS.inference))(nest_flat(flat))
    tb = _tb(batch)
    got = tm.inference(tb["phones"], tones=tb["tones"],
                       max_frames=max_frames, alpha=alpha)
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.full(2, per_token * T_TEXT))
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.asarray(want["frame_lengths"]))
    _close(got["mel"].detach(), want["mel"], what="mel")


def test_loss_matches_jax():
    """``speedyspeech_loss`` on given outputs: 1e-6 relative."""
    batch = _batch(7)
    rng = np.random.default_rng(8)
    outputs = {"mel": rng.standard_normal((2, FRAMES, 8)).astype(
        np.float32), "log_durations": rng.standard_normal(
        (2, T_TEXT)).astype(np.float32) * 2}
    want = j_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                  {k: jnp.asarray(v) for k, v in batch.items()})
    got = speedyspeech_loss(_tb(outputs), _tb(batch))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_train_step_matches_jax():
    """One Adam step (lr 1e-3) of the port's updater against the JAX
    updater's jitted step from the same weights and batch; see
    ``assert_adam_step_matches``."""
    jm, variables, tm, flat, batch = _pair(seed=9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jbuild("adam", LR)
    # init_speedyspeech_train_state's state, on the loaded weights
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        opt_state=tx.init(variables["params"]),
                        batch_stats=variables["batch_stats"],
                        rng=jax.random.PRNGKey(0))
    step = make_speedyspeech_train_step(jm, tx, jit=False)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jbatch["phones"], jbatch["durations"],
                          tones=jbatch["tones"], max_frames=FRAMES,
                          deterministic=False, mutable=["batch_stats"])
        return j_loss(out, jbatch)["loss"]

    # the updater's step and the gradient in one compiled program
    (new_state, want), grads = jax.jit(lambda st: (
        step(st, jbatch), jax.grad(loss_fn)(st.params)))(state)
    opt = build_optimizer(tm.parameters(), "adam", LR)
    tstate = t_init_state(tm, opt, torch.Generator().manual_seed(0))
    tstate, got = t_train_step(tm, opt)(tstate, _tb(batch))
    assert tstate.step == 1 and got["batch_size"].item() == 2.0
    assert_adam_step_matches(tm, flat, got, want, grads, new_state)


LR = 1e-3


def assert_adam_step_matches(tm, flat, got, want, grads, new_state):
    """The port's step against JAX's: every loss within 1e-5 relative;
    each parameter's gradient within 1e-4 relative L2 of ``jax.grad``'s;
    the parameters and BatchNorm statistics after the step within 1e-5
    of each leaf's range.  Adam's first step moves an element by lr times
    the sign of its gradient, so an element whose gradient is rounding
    noise (below 1e-3 of its leaf's largest: a conv bias whose ReLU passes
    every frame into batch-statistics BatchNorm has a true gradient of 0)
    is held to a move of at most lr instead."""
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    mine_g = {key: conv(t.grad.numpy()) for key, _, t, conv
              in _flax_leaves(tm) if key.startswith("params::")}
    jax_g = flatten_tree({"params": grads})
    after = flatten_tree({"params": new_state.params,
                          "batch_stats": new_state.batch_stats})
    mine = flax_arrays(tm)
    assert mine.keys() == after.keys() and mine_g.keys() == jax_g.keys()
    for key, g in jax_g.items():
        g = np.asarray(g, np.float64)
        rel = np.linalg.norm(mine_g[key] - g) / max(np.linalg.norm(g),
                                                    1e-30)
        assert rel <= 1e-4, (key, rel)
        sure = np.abs(g) >= 1e-3 * np.abs(g).max()
        _close(mine[key][sure], np.asarray(after[key])[sure], what=key)
        moved = np.abs(mine[key] - flat[key])[~sure]
        assert (moved <= LR * 1.001).all(), key
    for key in after:
        if key.startswith("batch_stats::"):
            _close(mine[key], after[key], what=key)


def test_batch_fn_matches_jax():
    """``speedyspeech_batch_fn`` against JAX's, bitwise: buckets of 16
    tokens and 64 frames, zero padding, lengths."""
    rng = np.random.default_rng(11)
    examples = []
    for n, f in ((5, 70), (17, 20), (9, 64)):
        examples.append({"phones": rng.integers(1, 30, n),
                         "tones": rng.integers(0, 5, n),
                         "durations": rng.integers(1, 6, n),
                         "feats": rng.standard_normal((f, 8)).astype(
                             np.float32)})
    want = j_batch_fn(examples)
    got = speedyspeech_batch_fn(examples)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["phones"].shape == (3, 32) and got["feats"].shape[1] == 128
    with pytest.raises(ValueError):
        speedyspeech_batch_fn([])
