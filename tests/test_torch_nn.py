"""FastSpeech2 building blocks of the PyTorch port against the JAX package.

Weights are drawn with numpy, loaded into flax and, through the bridge,
into the port; inputs are made with numpy from a seed.  Everything runs
in float32 and is held to 1e-5 (relative and absolute): the frameworks
sum float32 products and LayerNorm statistics in other orders, which
moves results by a few ulps of values of order one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.nn import postnet as jpost
from parakeet_tpu.nn import predictors as jpred
from parakeet_tpu.nn import transformer as jtr
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.nn import postnet as tpost
from parakeet_tpu_torch.nn import predictors as tpred
from parakeet_tpu_torch.nn import transformer as ttr

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
D, H, U = 16, 2, 24


def _randomize(flat, seed):
    """Redraw every leaf (flax inits biases to zero and scales to one,
    which would leave those paths untested)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf in ("scale", "var"):
            v = 1.0 + 0.2 * np.abs(rng.standard_normal(a.shape))
        elif leaf in ("bias", "mean", "alpha"):
            v = 0.2 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    return out


def _compare(jm, tm, args, seed=0, **kw):
    """Init ``jm`` on ``args`` (numpy), load the same weights into ``tm``
    and compare outputs.  Extra ``kw`` go to both calls."""
    jargs = [jnp.asarray(a) for a in args]
    v = jm.init(jax.random.PRNGKey(0), *jargs, **kw)
    flat = _randomize(flatten_tree(v), seed)
    load_flax_params(tm, flat)
    want = jm.apply(nest_flat(flat), *jargs, **kw)
    got = tm(*[torch.from_numpy(a) for a in args], **kw)
    return want, got


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None])[:, None, :]


@pytest.mark.parametrize("scaled", [False, True])
def test_positional_encoding_matches_jax(scaled):
    x = _np(0, 2, 11, D)
    if scaled:
        jm, tm = jtr.ScaledPositionalEncoding(D), ttr.ScaledPositionalEncoding(D)
    else:
        jm, tm = jtr.PositionalEncoding(D), ttr.PositionalEncoding(D)
    want, got = _compare(jm, tm, [x])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


def test_multi_head_attention_matches_jax():
    q, kv = _np(1, 2, 7, D), _np(2, 2, 9, D)
    mask = _mask([9, 4], 9)
    jm = jtr.MultiHeadAttention(H, D)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv),
                jnp.asarray(kv), jnp.asarray(mask))
    flat = _randomize(flatten_tree(v), 1)
    want = jm.apply(nest_flat(flat), jnp.asarray(q), jnp.asarray(kv),
                    jnp.asarray(kv), jnp.asarray(mask))[0]
    tm = ttr.MultiHeadAttention(H, D)
    load_flax_params(tm, flat)
    got = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("kind", ["ffn", "conv1d", "conv1d-linear"])
def test_positionwise_blocks_match_jax(kind):
    x = _np(3, 2, 10, D)
    if kind == "ffn":
        jm, tm = (jtr.PositionwiseFeedForward(U, D),
                  ttr.PositionwiseFeedForward(U, D))
    else:
        second = kind == "conv1d-linear"
        jm = jtr.MultiLayerConv(U, D, 3, second_linear=second)
        tm = ttr.MultiLayerConv(U, D, 3, second_linear=second)
    want, got = _compare(jm, tm, [x], seed=3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("normalize_before,ff", [(True, "conv1d"),
                                                 (False, "linear")])
def test_encoder_layer_matches_jax(normalize_before, ff):
    x, mask = _np(4, 2, 8, D), _mask([8, 5], 8)
    jm = jtr.EncoderLayer(D, H, U, normalize_before=normalize_before,
                          positionwise_layer_type=ff,
                          positionwise_conv_kernel_size=3)
    tm = ttr.EncoderLayer(D, H, U, normalize_before=normalize_before,
                          positionwise_layer_type=ff,
                          positionwise_conv_kernel_size=3)
    want, got = _compare(jm, tm, [x, mask], seed=4)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(_first(want)), **F32_TOL)


@pytest.mark.parametrize("input_layer", ["embed", None])
def test_transformer_encoder_matches_jax(input_layer):
    if input_layer == "embed":
        xs = np.array([[3, 7, 1, 9, 0, 0], [5, 2, 2, 8, 4, 6]], np.int64)
    else:
        xs = _np(5, 2, 6, D)
    mask = _mask([4, 6], 6)
    cfg = dict(d_model=D, n_heads=H, units=U, num_layers=2,
               input_layer=input_layer, vocab_size=12,
               positionwise_layer_type="conv1d",
               positionwise_conv_kernel_size=3)
    want, got = _compare(jtr.TransformerEncoder(**cfg),
                         ttr.TransformerEncoder(**cfg), [xs, mask], seed=5)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(_first(want)), **F32_TOL)


def test_attn_impl_flash_and_long_auto_raise():
    """Flash attention (kernel K4) is ported: 'flash', and 'auto' at
    AUTO_FLASH_MIN_T, run it (its plain version on the CPU) and agree with
    the dense core; what still raises is an unknown attn_impl and a head
    width K4 does not take (dk = 8 here)."""
    from parakeet_tpu_torch.models.fastspeech2 import make_attn_core
    with pytest.raises(ValueError, match="unknown attn_impl"):
        make_attn_core("ring")
    narrow = ttr.MultiHeadAttention(H, D, attn_core=make_attn_core("flash"))
    x = torch.zeros(1, 8, D)
    with pytest.raises(NotImplementedError, match="K4"):
        narrow(x, x, x)
    d, h = 32, 2
    dense = ttr.MultiHeadAttention(h, d)
    x = torch.from_numpy(_np(11, 1, ttr.AUTO_FLASH_MIN_T, d))
    want = dense(x, x, x)
    for impl in ("flash", "auto"):
        mha = ttr.MultiHeadAttention(h, d, attn_core=make_attn_core(impl))
        mha.load_state_dict(dense.state_dict())
        torch.testing.assert_close(mha(x, x, x), want, **F32_TOL)
    short = x[:, :-1]
    auto = ttr.MultiHeadAttention(h, d, attn_core=make_attn_core("auto"))
    auto.load_state_dict(dense.state_dict())
    torch.testing.assert_close(auto(short, short, short),
                               dense(short, short, short), rtol=0, atol=0)


def test_predictors_match_jax():
    xs = _np(6, 2, 9, D)
    pad = np.arange(9)[None, :] >= np.array([9, 6])[:, None]
    jm = jpred.DurationPredictor(n_layers=2, n_chans=12)
    tm = tpred.DurationPredictor(D, n_layers=2, n_chans=12)
    want, got = _compare(jm, tm, [xs, pad], seed=6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    jv = jpred.VariancePredictor(n_layers=2, n_chans=12)
    tv = tpred.VariancePredictor(D, n_layers=2, n_chans=12)
    want, got = _compare(jv, tv, [xs, pad[..., None]], seed=7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    je, te = jpred.VarianceEmbedding(D, 9), tpred.VarianceEmbedding(D, 9)
    want, got = _compare(je, te, [_np(8, 2, 9, 1)], seed=8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


def test_duration_rounding_matches_jax():
    """inference=True returns clip(round(exp(x) - 1), 0).  Both frameworks
    round half to even; the rounding is discontinuous, so the module check
    feeds log-durations away from the ties: a one-layer stack whose linear
    head ignores its input and reads only its bias."""
    ties = np.array([-0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(ties)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(ties))))
    xs = _np(9, 1, 12, D)
    jm = jpred.DurationPredictor(n_layers=1, n_chans=4)
    tm = tpred.DurationPredictor(D, n_layers=1, n_chans=4)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs))
    flat = _randomize(flatten_tree(v), 9)
    flat["params::stack::linear::kernel"][:] = 0.0
    for frames in (-0.7, 0.3, 1.2, 2.7, 6.1):
        flat["params::stack::linear::bias"][:] = np.log(frames + 1.0)
        load_flax_params(tm, flat)
        want = jm.apply(nest_flat(flat), jnp.asarray(xs), inference=True)
        got = tm(torch.from_numpy(xs), inference=True)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        assert got[0, 0].item() == max(round(frames), 0)


@pytest.mark.parametrize("use_batch_norm", [True, False])
def test_postnet_matches_jax(use_batch_norm):
    xs = _np(10, 2, 13, 6)
    jm = jpost.Postnet(odim=6, n_layers=3, n_chans=8,
                       use_batch_norm=use_batch_norm)
    tm = tpost.Postnet(6, n_layers=3, n_chans=8,
                       use_batch_norm=use_batch_norm)
    want, got = _compare(jm, tm, [xs], seed=10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
