"""The port's chunked Parallel WaveGAN inference (``pwg_streaming_inference``)
against the JAX package's, and against the port's one-shot
``pwg_inference``.

The same weights (drawn with numpy, loaded into flax and, through the
bridge, into the port) and the same noise go through both packages, in
float32 with the residual stack's layer loop on both sides (JAX's 'xla',
the port's 'eager').  The tolerance is tests/test_pwg_convs.py's for its
streaming test, 1e-5: the two frameworks sum float32 products in other
orders.  On the CUDA card the windows replay one captured graph
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from test_torch_pwg import _randomize

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GEN = dict(layers=6, stacks=2, residual_channels=32, gate_channels=64,
           skip_channels=32, aux_channels=10, aux_context_window=2,
           upsample_scales=(2, 2))
T_MEL, HOP = 50, 4


@pytest.fixture(scope="module")
def generators():
    """(JAX generator, its variables, port generator on the eager stack,
    port generator on K1's plain version), the same weights."""
    gen = jpwg.PWGGenerator(stack_impl="xla", **GEN)
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 1)),
                          jnp.zeros((1, 8, 10)))
    flat = _randomize(flatten_tree(v), 3)
    out = [gen, nest_flat(flat)]
    for impl in ("eager", "fused"):
        t = tpwg.PWGGenerator(stack_impl=impl, **GEN)
        load_flax_params(t, flat)
        out.append(t)
    return tuple(out)


def _inputs(seed=0, t_mel=T_MEL):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((1, t_mel, 10)).astype(np.float32)
    noise = rng.standard_normal((1, t_mel * HOP, 1)).astype(np.float32)
    return mel, noise


def test_windows_clamp_at_both_edges(generators):
    """At these widths the context is 8 frames: a 16-frame chunk vocodes
    four 32-frame windows over 50 frames, the first clamped to the start,
    the last to the end, one interior."""
    *_, teager, _ = generators
    c = tpwg._pwg_receptive_frames(teager)
    assert c == 8
    win = 16 + 2 * c
    starts = [min(max(s - c, 0), T_MEL - win) for s in range(0, T_MEL, 16)]
    assert starts == [0, 8, 18, 18]


@pytest.mark.parametrize("chunk", [16, 23])
def test_streaming_matches_jax(generators, chunk):
    """Aligned and ragged chunks, the same noise passed in on both
    sides."""
    jgen, jv, teager, _ = generators
    mel, noise = _inputs()
    want = jpwg.pwg_streaming_inference(jgen, jv, jnp.asarray(mel),
                                        noise=jnp.asarray(noise),
                                        chunk_frames=chunk)
    with torch.no_grad():
        got = tpwg.pwg_streaming_inference(
            teager, torch.from_numpy(mel), torch.from_numpy(noise),
            chunk_frames=chunk)
    assert got.shape == want.shape == (1, T_MEL * HOP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_streaming_matches_one_shot(generators):
    """Against the port's own ``pwg_inference`` on the whole mel, batched
    and unbatched, on the eager stack and on K1's plain version, and an
    utterance no longer than a window vocoded in one shot."""
    _, _, teager, tfused = generators
    mel, noise = _inputs(1)
    mel_t, noise_t = torch.from_numpy(mel), torch.from_numpy(noise)
    with torch.no_grad():
        for gen in (teager, tfused):
            full = tpwg.pwg_inference(gen, mel_t, noise=noise_t)
            for chunk in (16, 23):
                got = tpwg.pwg_streaming_inference(gen, mel_t, noise_t,
                                                   chunk_frames=chunk)
                np.testing.assert_allclose(got.numpy(), full.numpy(),
                                           **F32_TOL)
            one = tpwg.pwg_streaming_inference(gen, mel_t[0], noise_t,
                                               chunk_frames=16)
            assert one.shape == (T_MEL * HOP,)
            np.testing.assert_allclose(one.numpy(), full[0].numpy(),
                                       **F32_TOL)
        short_mel, short_noise = map(torch.from_numpy, _inputs(2, 30))
        assert torch.equal(
            tpwg.pwg_streaming_inference(teager, short_mel, short_noise,
                                         chunk_frames=16),
            tpwg.pwg_inference(teager, short_mel, noise=short_noise))


class _EagerProgram:
    """Stands in for ``CapturedProgram`` on the CPU: the same static
    inputs, ``fn`` run eagerly at each replay."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs, self.replays = fn, inputs, 0

    def __call__(self):
        self.replays += 1
        return self.fn(**self.inputs)


def test_window_program_needs_a_cuda_device(generators):
    *_, teager, _ = generators
    mel, _ = _inputs(1)
    with pytest.raises(ValueError, match="CUDA device"):
        tpwg.pwg_window_program(teager, torch.from_numpy(mel),
                                chunk_frames=16)


def test_streaming_replays_the_callers_window_program(generators,
                                                      monkeypatch):
    """The windows go through the caller's program, one replay a window,
    bit for bit the eager windows; a program made for another window
    shape is refused."""
    *_, teager, _ = generators
    monkeypatch.setattr(tpwg, "CapturedProgram", _EagerProgram)
    mel_t, noise_t = map(torch.from_numpy, _inputs(1))
    with torch.no_grad():
        prog = tpwg.pwg_window_program(teager, mel_t, noise_t,
                                       chunk_frames=16)
        assert prog.inputs["mel"].shape == (1, 32 + 2 * 2, 10)
        assert prog.inputs["noise"].shape == (1, 32 * HOP, 1)
        want = tpwg.pwg_streaming_inference(teager, mel_t, noise_t,
                                            chunk_frames=16)
        got = tpwg.pwg_streaming_inference(teager, mel_t, noise_t,
                                           chunk_frames=16, program=prog)
        assert prog.replays == 4 and torch.equal(got, want)
        with pytest.raises(ValueError, match="window inputs"):
            tpwg.pwg_streaming_inference(teager, mel_t, noise_t,
                                         chunk_frames=23, program=prog)


@pytest.mark.parametrize("conf", ["default", "ljspeech", "vctk"])
def test_receptive_frames_match_jax_for_the_recipes(conf):
    path = (pathlib.Path(__file__).resolve().parents[1] / "recipes" / "pwgan"
            / "conf" / f"{conf}.yaml")
    with open(path) as f:
        params = yaml.safe_load(f)["generator_params"]
    widths = {k: v for k, v in params.items()
              if k in ("layers", "stacks", "kernel_size",
                       "residual_channels", "gate_channels",
                       "skip_channels", "aux_channels",
                       "aux_context_window", "upsample_scales")}
    want = jpwg._pwg_receptive_frames(jpwg.PWGGenerator(**widths))
    assert tpwg._pwg_receptive_frames(tpwg.PWGGenerator(**widths)) == want
