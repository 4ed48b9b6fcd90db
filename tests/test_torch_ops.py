"""Tensor functions and the weight bridge of the PyTorch port against the
JAX package.

Inputs are made with numpy from a seed and fed to both sides.  Integer and
boolean results must be equal; float32 results are held to 1e-6, since the
two frameworks' sin, cos and power differ by an ulp or so.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.ops import geometry as jgeo
from parakeet_tpu.ops import length_regulator as jlr
from parakeet_tpu.ops import masking as jmask
from parakeet_tpu.ops import normalizer as jnorm
from parakeet_tpu.ops import positional as jpos
from parakeet_tpu_torch import bridge
from parakeet_tpu_torch.ops import geometry as tgeo
from parakeet_tpu_torch.ops import length_regulator as tlr
from parakeet_tpu_torch.ops import masking as tmask
from parakeet_tpu_torch.ops import normalizer as tnorm
from parakeet_tpu_torch.ops import positional as tpos

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def test_sequence_mask_matches_jax():
    lengths = np.array([0, 3, 7, 9], np.int64)
    want = np.asarray(jmask.sequence_mask(jnp.asarray(lengths), 7))
    got = tmask.sequence_mask(torch.from_numpy(lengths), 7).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.bool_


@pytest.mark.parametrize("n,d,start", [(50, 16, 0), (13, 384, 5)])
def test_sinusoid_position_encoding_matches_jax(n, d, start):
    want = np.asarray(jpos.sinusoid_position_encoding(n, d, start_pos=start))
    got = tpos.sinusoid_position_encoding(n, d, start_pos=start).numpy()
    # angles reach ~60 rad; an ulp of the angle is ~4e-6 there
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.allclose(got[:, 0], np.sin(np.arange(start, start + n)))


@pytest.mark.parametrize("off", [-9, -3, 0, 2, 9])
def test_time_shift_matches_jax(off):
    x = np.random.default_rng(0).standard_normal((2, 8, 3)).astype(np.float32)
    want = np.asarray(jgeo.time_shift(jnp.asarray(x), off))
    got = tgeo.time_shift(torch.from_numpy(x), off).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [1.0, 1.3])
def test_length_regulate_matches_jax(alpha):
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((3, 6, 4)).astype(np.float32)
    dur = rng.integers(0, 4, (3, 6)).astype(np.int64)
    dur[2] = [5, 5, 5, 5, 5, 5]          # total 30 > max_len: clipped
    want_f, want_t = jlr.length_regulate(jnp.asarray(enc), jnp.asarray(dur),
                                         max_len=20, alpha=alpha)
    got_f, got_t = tlr.length_regulate(torch.from_numpy(enc),
                                       torch.from_numpy(dur), max_len=20,
                                       alpha=alpha)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_zscore_matches_jax():
    rng = np.random.default_rng(2)
    mu, sigma = rng.standard_normal(5), rng.random(5) + 0.5
    x = rng.standard_normal((2, 4, 5)).astype(np.float32)
    j = jnorm.ZScore(mu.astype(np.float32), sigma.astype(np.float32))
    t = tnorm.ZScore(mu.astype(np.float32), sigma.astype(np.float32))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(t.transform(xt).numpy(),
                               np.asarray(j.transform(jnp.asarray(x))),
                               **F32_TOL)
    np.testing.assert_allclose(t.inverse(xt).numpy(),
                               np.asarray(j.inverse(jnp.asarray(x))),
                               **F32_TOL)
    np.testing.assert_allclose(t.inverse(t(xt)).numpy(), x, rtol=1e-5,
                               atol=1e-5)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(4, 6)
        self.bn = torch.nn.BatchNorm1d(3)
        self.alpha = torch.nn.Parameter(torch.zeros(1))


def _tiny_flat():
    rng = np.random.default_rng(3)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"params::dense::kernel": r(4, 2, 3),   # DenseGeneral-style
            "params::dense::bias": r(2, 3),
            "params::bn::scale": r(3), "params::bn::bias": r(3),
            "batch_stats::bn::mean": r(3), "batch_stats::bn::var": r(3),
            "params::alpha": r(1)}


def test_bridge_maps_layouts():
    flat = _tiny_flat()
    m = _Tiny()
    bridge.load_flax_params(m, flat)
    np.testing.assert_array_equal(
        m.dense.weight.detach().numpy(),
        flat["params::dense::kernel"].reshape(4, 6).T)
    np.testing.assert_array_equal(m.dense.bias.detach().numpy(),
                                  flat["params::dense::bias"].reshape(6))
    np.testing.assert_array_equal(m.bn.running_var.numpy(),
                                  flat["batch_stats::bn::var"])
    np.testing.assert_array_equal(m.alpha.detach().numpy(),
                                  flat["params::alpha"])


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_bridge_raises_on_missing_unused_or_misshapen(fault):
    flat = _tiny_flat()
    if fault == "missing":
        del flat["batch_stats::bn::mean"]
    elif fault == "unused":
        flat["params::dense::extra"] = np.zeros(2, np.float32)
    else:
        flat["params::alpha"] = np.zeros(2, np.float32)
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err, match="bn.running_mean" if fault == "missing"
                       else "extra" if fault == "unused" else "alpha"):
        bridge.load_flax_params(_Tiny(), flat)
