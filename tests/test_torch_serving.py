"""The port's serving engine as a grid of programs, on the CPU (eager), as
tests/test_serving.py holds the JAX engine: its program count, warm-up,
the graph option's guard, the repairs that CUDA graph capture needed (a
positional table made without a host copy, the upsampler's masks made
once, normalizer statistics moved to the engine's device once) and the
engine's wavs against the JAX
engine's on the same noise.  The captured graphs themselves are held
bitwise against the eager engine on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import PWGGenerator as JPWG
from parakeet_tpu.serving import TTSEngine as JEngine
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.ops.kernels import pwg_stack
from parakeet_tpu_torch.ops.normalizer import ZScore
from parakeet_tpu_torch.ops.positional import sinusoid_position_encoding
from parakeet_tpu_torch.serving import Request, TTSEngine
from parakeet_tpu_torch.utils.graphs import CapturedProgram
from test_torch_slice import FS2, HOP, MAX_FRAMES, PWG, WAV_REL_TOL, \
    _randomize

torch.set_num_threads(1)

GRID = dict(text_buckets=(8, 16), batch_buckets=(1, 2, 4),
            frames_per_token=4, min_duration=1)


@pytest.fixture(scope="module")
def models():
    """JAX and port models with the same weights, as test_torch_slice's
    fixture builds them: (jfs2, jfs2_vars, tfs2, jpwg, jpwg_vars, tpwg)."""
    jfs2 = JFS2(**FS2)
    v = jax.jit(lambda k: jfs2.init(
        {"params": k}, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
        max_frames=MAX_FRAMES, spk_id=jnp.asarray([0]),
        method=JFS2.inference))(jax.random.PRNGKey(0))
    flat = _randomize(flatten_tree(v), 0)
    tfs2 = FastSpeech2(**FS2)
    load_flax_params(tfs2, flat)
    jpwg = JPWG(stack_impl="pallas", **PWG)
    pv = jax.jit(JPWG(stack_impl="xla", **PWG).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16 * HOP, 1)),
        jnp.zeros((1, 18, 10)))
    pflat = _randomize(flatten_tree(pv), 1)
    tpwg = PWGGenerator(stack_impl="fused", **PWG)
    load_flax_params(tpwg, pflat)
    return jfs2, nest_flat(flat), tfs2, jpwg, nest_flat(pflat), tpwg


@pytest.fixture
def engine(models):
    *_, tfs2, _, _, tpwg = models
    return TTSEngine(tfs2, voc=tpwg, **GRID)


def _reqs(lengths, base_seed=0):
    rng = np.random.default_rng(7)
    return [Request(ids=rng.integers(1, 30, n).tolist(), utt_id=f"u{i}",
                    seed=base_seed + i) for i, n in enumerate(lengths)]


def test_engine_is_eager_on_the_cpu(engine):
    assert engine.graphs is False and engine.compiled_programs == 0


def test_compile_cache_reuse(engine):
    """As tests/test_serving.py::test_compile_cache_reuse: a second batch
    on the same grid point builds no program."""
    engine.synthesize(_reqs([4, 6, 2], base_seed=50))
    before = engine.compiled_programs
    assert before == 1
    engine.synthesize(_reqs([7, 5, 3], base_seed=90))   # the same (8, 4)
    assert engine.compiled_programs == before


def test_warmup_precompiles(engine):
    """As tests/test_serving.py::test_warmup_precompiles: warm-up returns
    the program count, and by default covers the full grid."""
    n = engine.warmup(text_buckets=(8,), batch_buckets=(2,))
    assert n == engine.compiled_programs == 1
    engine.synthesize(_reqs([8, 8], base_seed=70))        # hits (8, 2)
    assert engine.compiled_programs == 1
    assert engine.warmup() == 2 * 3     # text (8, 16) x batch (1, 2, 4)


def test_graphs_on_cpu_models_raise(models):
    *_, tfs2, _, _, tpwg = models
    with pytest.raises(ValueError, match="CUDA device"):
        TTSEngine(tfs2, voc=tpwg, graphs=True, **GRID)
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedProgram(lambda x: x, {"x": torch.zeros(2)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_positional_table_is_bitwise_the_host_copy_version(dtype):
    """The table made with ``torch.full`` on the device is bit for bit the
    one made from ``torch.tensor(1e4)``, the host copy that capture
    refuses."""
    f32 = torch.float32
    for n, d, start in ((1, 2, 0), (17, 16, 0), (128, 384, 0),
                        (896, 384, 3), (1000, 80, 11)):
        channel = torch.arange(0, d, 2, dtype=f32)
        index = torch.arange(n, dtype=f32) + start
        denom = torch.pow(torch.tensor(1e4, dtype=f32), channel / d)
        angle = index[:, None] / denom[None, :]
        want = torch.zeros((n, d), dtype=f32)
        want[:, 0::2] = torch.sin(angle)
        want[:, 1::2] = torch.cos(angle[:, :d // 2])
        got = sinusoid_position_encoding(n, d, start_pos=start, dtype=dtype)
        assert got.dtype == dtype
        assert torch.equal(got, want.to(dtype)), (n, d, start)


def test_upsampler_phase_masks_are_buffers_made_once():
    """The polyphase masks, once made from numpy in every forward (a host
    copy that capture refuses), are buffers: the same values, moved with
    the module, out of the state dict."""
    net = PWGGenerator(**PWG).upsample_net.upsample
    for i, s in enumerate(PWG["upsample_scales"]):
        masks = getattr(net, f"conv_{i}_masks")
        assert torch.equal(masks, torch.from_numpy(tpwg._phase_masks(s)))
        assert net.to(torch.bfloat16).get_buffer(
            f"conv_{i}_masks").dtype == torch.bfloat16
    assert not any("masks" in k for k in net.state_dict())


def test_cpu_statistics_move_to_the_engine_device_once(models):
    """A ZScore with CPU statistics ends up on the models' device at
    construction (the meta device stands in for the card), and the
    caller's normalizer is left as it was."""
    *_, tfs2, _, _, tpwg = models
    am_norm = ZScore(torch.zeros(10), torch.ones(10))
    voc_norm = ZScore(torch.full((10,), 0.5), torch.full((10,), 2.0))
    meta = TTSEngine(FastSpeech2(**FS2).to("meta"),
                     voc=PWGGenerator(**PWG).to("meta"), am_norm=am_norm,
                     voc_norm=voc_norm, graphs=False, **GRID)
    for norm in (meta.am_norm, meta.voc_norm):
        assert norm.mu.device.type == norm.sigma.device.type == "meta"
    assert am_norm.mu.device.type == "cpu"
    moved = voc_norm.to("cpu")
    assert torch.equal(moved.mu, voc_norm.mu)
    x = torch.randn(2, 3, 10)
    assert torch.equal(moved.transform(x), voc_norm.transform(x))
    # on the CPU the moved normalizers give the engine's results unchanged
    eng = TTSEngine(tfs2, voc=tpwg, am_norm=am_norm, voc_norm=voc_norm,
                    **GRID)
    ref = TTSEngine(tfs2, voc=tpwg, **GRID)
    ref.am_norm, ref.voc_norm = am_norm, voc_norm
    reqs = _reqs([5, 9])
    for a, b in zip(eng.synthesize(reqs), ref.synthesize(reqs)):
        assert np.array_equal(a.wav, b.wav)


def test_engine_matches_the_jax_engine(models):
    """The port's engine against the JAX engine on the same weights and
    the same noise rows (the JAX engine's, handed to the port's), through
    test_torch_slice's path: the Pallas stack in interpret mode against
    K1's plain version, each wav held to 2^-8 of its range, frame counts
    exactly."""
    jfs2, jv, tfs2, jpwg, jpv, tpwg = models
    jeng = JEngine(jfs2, jv, voc=jpwg, voc_params=jpv["params"], **GRID)
    teng = TTSEngine(tfs2, voc=tpwg, **GRID)
    teng._noise_row = lambda seed, tb: torch.from_numpy(
        np.array(jeng._noise_row(seed, tb)))
    reqs = _reqs([5, 12, 3, 9], base_seed=11)
    want, got = jeng.synthesize(reqs), teng.synthesize(reqs)
    for w, g in zip(want, got):
        assert g.utt_id == w.utt_id and g.n_frames == w.n_frames > 0
        assert g.wav.shape == w.wav.shape and np.isfinite(g.wav).all()
        tol = WAV_REL_TOL * np.abs(w.wav).max()
        np.testing.assert_allclose(g.wav, w.wav, rtol=0, atol=tol,
                                   err_msg=w.utt_id)


def test_capture_errors_are_not_reported_as_launch_errors(monkeypatch):
    """check_launch names a failed capture (cudaErrorStreamCapture*, 900
    to 908) as the capture's fault, any other code as the launch's."""
    class Lib:
        @staticmethod
        def pwg_stack_error_string(err):
            return f"error {err}".encode()

    monkeypatch.setattr(pwg_stack, "_lib", lambda: Lib)
    pwg_stack.check_launch("k", 0)
    with pytest.raises(RuntimeError, match="capture failed when k"):
        pwg_stack.check_launch("k", 901)
    with pytest.raises(RuntimeError, match="^k failed: error 700"):
        pwg_stack.check_launch("k", 700)
