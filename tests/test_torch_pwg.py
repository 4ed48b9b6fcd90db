"""Parallel WaveGAN generator of the PyTorch port against the JAX package.

The same weights (drawn with numpy, loaded into flax and, through the
bridge, into the port) and the same inputs go through both.  float32 modules
are held to 1e-5: the two frameworks sum float32 products in other orders,
which moves results by a few ulps.  The fused stack (kernel K1) is held
against the Pallas kernel run in interpret mode, as
tests/test_pwg_pallas_stack.py runs it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.ops.kernels import pwg_stack as tstack

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STACK = dict(layers=6, stacks=3, kernel_size=3, residual_channels=32,
             gate_channels=64, skip_channels=32, aux_channels=20)


def _randomize(flat, seed):
    """Redraw every leaf: kernels N(0, 1/fan_in), weight-norm scales
    around 1, biases N(0, 0.1) (flax would init biases to zero, which
    would leave the bias paths untested)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf.endswith("scale"):
            v = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif leaf.endswith("bias"):
            v = 0.1 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    return out


def _init(module, seed, *args, **kw):
    """Init ``module`` in flax, redraw its params; (flat, jax variables)."""
    v = jax.jit(functools.partial(module.init, **kw))(
        jax.random.PRNGKey(0), *args)
    flat = _randomize(flatten_tree(v), seed)
    return flat, nest_flat(flat)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_wn_and_conv1d_taps_match_jax():
    kernel, scale = _np(0, 3, 6, 5), 1.0 + _np(1, 5)
    np.testing.assert_allclose(
        tpwg._wn(torch.from_numpy(kernel), torch.from_numpy(scale)).numpy(),
        np.asarray(jpwg._wn(jnp.asarray(kernel), jnp.asarray(scale))),
        **F32_TOL)
    x = _np(2, 2, 17, 6)
    for pad, dil in (("SAME", 1), ("SAME", 4), ("VALID", 2)):
        want = jpwg.conv1d_taps(jnp.asarray(x), jnp.asarray(kernel), dil, pad)
        got = tpwg.conv1d_taps(torch.from_numpy(x), torch.from_numpy(kernel),
                               dil, pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_phase_masks_match_jax():
    for s in (2, 3, 4, 5):
        np.testing.assert_array_equal(tpwg._phase_masks(s),
                                      jpwg._phase_masks(s))


@pytest.mark.parametrize("name", ["wnconv", "upsample", "conv_in_upsample"])
def test_pwg_modules_match_jax(name):
    if name == "wnconv":
        jm = jpwg.WNConv1d(7, 3, dilation=2)
        tm = tpwg.WNConv1d(5, 7, 3, dilation=2)
        x = _np(3, 2, 20, 5)
    elif name == "upsample":
        jm = jpwg.UpsampleNet((4, 5, 3))
        tm = tpwg.UpsampleNet((4, 5, 3))
        x = _np(3, 2, 9, 6)
    else:
        jm = jpwg.ConvInUpsampleNet((2, 3), aux_channels=6,
                                    aux_context_window=2)
        tm = tpwg.ConvInUpsampleNet((2, 3), aux_channels=6,
                                    aux_context_window=2)
        x = _np(3, 2, 12, 6)
    flat, variables = _init(jm, 4, jnp.asarray(x))
    load_flax_params(tm, flat)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)


def _stacks(t, seed):
    """(flat, jax variables, x, c) for a JAX and a port ResidualStack."""
    x, c = _np(seed, 2, t, 32), _np(seed + 1, 2, t, 20)
    flat, variables = _init(jpwg.ResidualStack(impl="xla", **STACK), seed,
                            jnp.asarray(x), jnp.asarray(c))
    return flat, variables, x, c


def test_eager_stack_matches_jax_xla():
    flat, variables, x, c = _stacks(50, 5)
    want_x, want_s = jpwg.ResidualStack(impl="xla", **STACK).apply(
        variables, jnp.asarray(x), jnp.asarray(c))
    port = tpwg.ResidualStack(impl="eager", **STACK)
    load_flax_params(port, flat)
    got_x, got_s = port(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x),
                               **F32_TOL)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **F32_TOL)


# K1's plain version against the Pallas kernel.  Both round at the same
# points (bf16 operands, f32 accumulation, bf16 h, bf16 x at group ends);
# they differ only in the order of float32 sums, which now and then flips
# a bf16 rounding by one ulp.  The tolerance is one bf16 ulp of x (2^-7
# relative; x is bf16): far tighter than the 0.05 the Pallas kernel is held
# to against the float32 XLA stack.  (Measured: 1 ulp on ~4% of x, skip
# within 0.005.)
K1_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("t", [300, 700])
def test_k1_reference_matches_pallas_interpret(t, monkeypatch):
    """t=700 shrinks the Pallas block so that T spans several blocks and
    the carried left tails and right halo come into play, as in
    tests/test_pwg_pallas_stack.py::test_pallas_stack_cross_block_tails."""
    if t > 300:
        from parakeet_tpu.ops.pallas import pwg_stack
        monkeypatch.setattr(pwg_stack, "_BLOCK", 256)
        monkeypatch.setattr(pwg_stack, "_HALO", 64)
        monkeypatch.setattr(pwg_stack, "_SLACK", 32)
    flat, variables, x, c = _stacks(t, 6)
    want_x, want_s = jpwg.ResidualStack(impl="pallas", **STACK).apply(
        variables, jnp.asarray(x), jnp.asarray(c))
    port = tpwg.ResidualStack(impl="fused", **STACK)
    load_flax_params(port, flat)
    tstack.fused_residual_stack.launches = 0
    got_x, got_s = port(torch.from_numpy(x), torch.from_numpy(c))
    # on CPU tensors the wrapper runs the plain version: no launch
    assert tstack.fused_residual_stack.launches == 0
    got_x = got_x.detach().float().numpy()
    np.testing.assert_allclose(got_x, np.asarray(want_x, np.float32),
                               **K1_TOL)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **K1_TOL)


def test_k1_reference_matches_eager_stack_to_bf16():
    """The plain version's packing (tap order, aux and gate-bias rows,
    [skip | res] split) agrees with the float32 eager stack up to bf16
    rounding."""
    flat, _, x, c = _stacks(64, 7)
    eager = tpwg.ResidualStack(impl="eager", **STACK)
    load_flax_params(eager, flat)
    want_x, want_s = eager(torch.from_numpy(x), torch.from_numpy(c))
    got_x, got_s = tstack.fused_residual_stack_reference(
        torch.from_numpy(x), torch.from_numpy(c), eager.fused_weights(),
        dilations=eager.dilations(), stacks=eager.stacks)
    torch.testing.assert_close(got_x.float(), want_x, rtol=0.05, atol=0.05)
    torch.testing.assert_close(got_s, want_s, rtol=0.05, atol=0.05)


def test_fused_stack_supported_and_wrapper_devices():
    assert tpwg.ResidualStack(**STACK).supported
    assert not tstack.fused_stack_supported(48, 96, 48, 3, 6, 3, 20)
    assert not tstack.fused_stack_supported(32, 64, 32, 3, 6, 3, None)
    with pytest.raises(ValueError, match="unsupported"):
        tpwg.ResidualStack(impl="fused", **dict(STACK, aux_channels=None))
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="both must be CUDA or both CPU"):
        tstack.fused_residual_stack(x, torch.zeros(1, 8, 20, device="meta"),
                                    {}, dilations=(1,) * 6, stacks=3)


def test_generator_matches_jax():
    cfg = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
               skip_channels=32, aux_channels=10, aux_context_window=1,
               upsample_scales=(2, 3))
    mel, noise = _np(8, 2, 10, 10), _np(9, 2, 8 * 6, 1)
    jm = jpwg.PWGGenerator(stack_impl="xla", **cfg)
    flat, variables = _init(jm, 10, jnp.asarray(noise), jnp.asarray(mel))
    port = tpwg.PWGGenerator(stack_impl="eager", **cfg)
    load_flax_params(port, flat)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(noise),
                                        jnp.asarray(mel)))
    got = port(torch.from_numpy(noise), torch.from_numpy(mel))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32_TOL)
    # pwg_inference edge-pads the mel like the JAX function
    want_inf = np.asarray(jpwg.pwg_inference(
        jm, variables, jnp.asarray(mel[:, 1:-1]), noise=jnp.asarray(noise)))
    got_inf = tpwg.pwg_inference(port, torch.from_numpy(mel[:, 1:-1]),
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got_inf.detach().numpy(), want_inf, **F32_TOL)
    # without noise it is drawn from the given generator, reproducibly
    mel1 = torch.from_numpy(mel[0, 1:-1])
    a, b = (tpwg.pwg_inference(port, mel1, rng=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert a.shape == (8 * 6,) and torch.equal(a, b)
