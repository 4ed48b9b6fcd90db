"""The port's serving slice against the JAX package: phone ids ->
FastSpeech2.inference -> edge-padded mel -> PWGGenerator -> waveform, plus
the port TTSEngine's bucketing, splitting and batch invariance.

Weights are drawn with numpy and loaded into both packages; inputs and
noise are made with numpy from a seed.  The acoustic model runs in float32
and is held to 1e-5.  The vocoder's residual stack is the fused one on
both sides (the Pallas kernel in interpret mode; the port's K1 plain
version on CPU tensors), which rounds to bf16 inside, so the waveform is
held to 2^-8 of its range, one bf16 ulp: the two sides' float32 sums
differ in order, which now and then flips a bf16 rounding inside the
stack.  (Measured: 7.7e-4 at a range of 1.2.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import PWGGenerator as JPWG
from parakeet_tpu.ops.masking import sequence_mask as jmask
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
from parakeet_tpu_torch.models.parallel_wavegan import pwg_inference
from parakeet_tpu_torch.ops.masking import sequence_mask
from parakeet_tpu_torch.serving import Request, TTSEngine

torch.set_num_threads(1)

FS2 = dict(idim=30, odim=10, adim=16, aheads=2, elayers=2, eunits=32,
           dlayers=2, dunits=32, postnet_layers=2, postnet_chans=8,
           postnet_filts=5, duration_predictor_chans=16,
           pitch_predictor_chans=16, energy_predictor_chans=16,
           positionwise_layer_type="conv1d",
           positionwise_conv_kernel_size=3, num_speakers=3, spk_embed_dim=8)
PWG = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
           skip_channels=32, aux_channels=10, aux_context_window=1,
           upsample_scales=(2, 2))
HOP = 4
MAX_FRAMES = 32
F32_TOL = dict(rtol=1e-5, atol=1e-5)
WAV_REL_TOL = 2 ** -8


def _randomize(flat, seed):
    """Redraw every leaf; log-durations near 0.9 with a spread of ~0.3
    (one or two frames a token), so that utterances fill part of the
    capacity."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat.items():
        leaf = key.split("::")[-1]
        if leaf.endswith("scale") or leaf == "var":
            v = 1.0 + 0.2 * np.abs(rng.standard_normal(a.shape))
        elif leaf.endswith("bias") or leaf in ("mean", "alpha"):
            v = 0.1 * rng.standard_normal(a.shape)
        else:
            v = rng.standard_normal(a.shape) / np.sqrt(max(a[0].size, 1))
        out[key] = v.astype(np.float32)
    head = "params::duration_predictor::stack::linear::"
    if head + "bias" in out:
        out[head + "kernel"] *= 0.25
        out[head + "bias"][:] = 0.9
    return out


@pytest.fixture(scope="module")
def models():
    """JAX and port FastSpeech2 and PWGGenerator with the same weights:
    (jfs2, jfs2_vars, tfs2, jpwg, jpwg_vars, tpwg)."""
    jfs2 = JFS2(**FS2)
    v = jax.jit(lambda k: jfs2.init(
        {"params": k}, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]),
        max_frames=MAX_FRAMES, spk_id=jnp.asarray([0]),
        method=JFS2.inference))(jax.random.PRNGKey(0))
    flat = _randomize(flatten_tree(v), 0)
    tfs2 = FastSpeech2(**FS2)
    load_flax_params(tfs2, flat)
    jpwg = JPWG(stack_impl="pallas", **PWG)
    # the same parameter tree; initializing through the XLA stack is cheap
    pv = jax.jit(JPWG(stack_impl="xla", **PWG).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16 * HOP, 1)),
        jnp.zeros((1, 18, 10)))
    pflat = _randomize(flatten_tree(pv), 1)
    tpwg = PWGGenerator(stack_impl="fused", **PWG)
    load_flax_params(tpwg, pflat)
    return jfs2, nest_flat(flat), tfs2, jpwg, nest_flat(pflat), tpwg


def _batch():
    rng = np.random.default_rng(5)
    lengths = np.array([12, 7, 9], np.int64)
    text = np.zeros((3, 12), np.int64)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, 30, n)
    spk = np.array([0, 2, 1], np.int64)
    return text, lengths, spk


def _jax_log_durations(m, text, lengths, spk):
    hs = m._encode(text, lengths, spk, None, None, True)
    return m.duration_predictor(hs, ~jmask(lengths, text.shape[1]))


def _jax_inference(jfs2, jv, text, lengths, spk):
    return jax.jit(lambda *a: jfs2.apply(
        jv, *a[:2], max_frames=MAX_FRAMES, spk_id=a[2], min_duration=1,
        method=JFS2.inference))(text, lengths, spk)


def test_fastspeech2_inference_matches_jax(models):
    jfs2, jv, tfs2, *_ = models
    text, lengths, spk = _batch()
    jt, jl, js = map(jnp.asarray, (text, lengths, spk))
    tt, tl, ts = map(torch.from_numpy, (text, lengths, spk))
    with torch.no_grad():
        # log-domain durations, before the discontinuous rounding
        want_log = jax.jit(lambda *a: jfs2.apply(
            jv, *a, method=_jax_log_durations))(jt, jl, js)
        got_log = tfs2.duration_predictor(
            tfs2._encode(tt, tl, ts, None), ~sequence_mask(tl, 12))
        np.testing.assert_allclose(got_log.numpy(), np.asarray(want_log),
                                   **F32_TOL)
        # the JAX durations go into both, so a flip cannot shift frames
        want = _jax_inference(jfs2, jv, jt, jl, js)
        ds = np.array(want["d_outs"])
        got = tfs2.inference(tt, tl, max_frames=MAX_FRAMES, spk_id=ts,
                             min_duration=1, durations=torch.from_numpy(ds))
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.asarray(want["frame_lengths"]))
    assert 0 < got["frame_lengths"].min() < MAX_FRAMES
    np.testing.assert_allclose(got["after_outs"].numpy(),
                               np.asarray(want["after_outs"]), **F32_TOL)


def test_slice_waveform_matches_jax_pallas(models):
    """Each side vocodes its own mel; the stacks are Pallas (interpret) and
    K1's plain version."""
    jfs2, jv, tfs2, jpwg, jpv, tpwg = models
    text, lengths, spk = _batch()
    jt, jl, js = map(jnp.asarray, (text, lengths, spk))
    want = _jax_inference(jfs2, jv, jt, jl, js)
    ds = torch.from_numpy(np.array(want["d_outs"]))
    noise = np.random.default_rng(6).standard_normal(
        (3, MAX_FRAMES * HOP, 1)).astype(np.float32)
    want_wav = np.asarray(jax.jit(lambda m, z: jpwg.apply(
        jpv, z, jnp.pad(m, ((0, 0), (1, 1), (0, 0)), mode="edge")))(
            want["after_outs"], jnp.asarray(noise)))[..., 0]
    with torch.no_grad():
        got = tfs2.inference(*map(torch.from_numpy, (text, lengths)),
                             max_frames=MAX_FRAMES,
                             spk_id=torch.from_numpy(spk), min_duration=1,
                             durations=ds)
        got_wav = pwg_inference(tpwg, got["after_outs"],
                                noise=torch.from_numpy(noise)).numpy()
    assert got_wav.shape == want_wav.shape == (3, MAX_FRAMES * HOP)
    assert np.isfinite(got_wav).all()
    tol = WAV_REL_TOL * np.abs(want_wav).max()
    np.testing.assert_allclose(got_wav, want_wav, rtol=0, atol=tol)


# ---- the port's engine ---------------------------------------------------


@pytest.fixture(scope="module")
def engine(models):
    *_, tfs2, _, _, tpwg = models
    return TTSEngine(tfs2, voc=tpwg, text_buckets=(8, 16),
                     batch_buckets=(1, 2, 4), frames_per_token=4,
                     min_duration=1)


def _reqs(lengths, base_seed=0):
    rng = np.random.default_rng(7)
    return [Request(ids=rng.integers(1, 30, n).tolist(), utt_id=f"u{i}",
                    seed=base_seed + i) for i, n in enumerate(lengths)]


def test_engine_batch_invariance(engine):
    """As tests/test_serving.py::test_batch_invariance: a request's wav is
    the same alone (batch bucket 1) and inside a padded chunk (bucket 4),
    to the same 1e-5."""
    reqs = _reqs([5, 8, 3])
    batched = engine.synthesize(reqs)
    solo = [engine.synthesize([r])[0] for r in reqs]
    for b, s, r in zip(batched, solo, reqs):
        assert b.utt_id == s.utt_id == r.utt_id
        assert b.n_frames == s.n_frames > 0
        assert b.wav.shape == (b.n_frames * HOP,)
        assert np.isfinite(b.wav).all()
        np.testing.assert_allclose(b.wav, s.wav, atol=1e-5,
                                   err_msg=r.utt_id)


def test_engine_matches_trimmed_vocode(engine, models):
    """As tests/test_serving.py::test_engine_matches_trimmed_vocode: the
    vocoder's input past a row's length repeats the row's last real frame,
    so the engine's wav is the trimmed mel edge-extended to capacity and
    vocoded with the request's noise row."""
    *_, tfs2, _, _, tpwg = models
    (req,) = _reqs([6], base_seed=40)
    (res,) = engine.synthesize([req])
    text = torch.zeros((1, 8), dtype=torch.int64)
    text[0, :6] = torch.tensor(req.ids)
    with torch.no_grad():
        out = tfs2.inference(text, torch.tensor([6]), max_frames=32,
                             min_duration=1)
        n = int(out["frame_lengths"][0])
        assert n == res.n_frames
        idx = torch.clamp(torch.arange(32), max=n - 1)
        mel_full = out["after_outs"][:, :n][:, idx]
        noise = engine._noise_row(req.seed, 8)[None]
        wav = pwg_inference(tpwg, mel_full, noise=noise)[0, :n * HOP]
    np.testing.assert_allclose(res.wav, wav.numpy(), rtol=0, atol=1e-6)


def test_engine_splits_long_requests_and_overflow_policies(models):
    *_, tfs2, _, _, _ = models
    kw = dict(text_buckets=(8, 16), batch_buckets=(1, 2),
              frames_per_token=4)
    eng = TTSEngine(tfs2, split_ids=[3], **kw)     # mel-only engine
    ids = [1] * 10 + [3] + [1] * 10
    assert eng._segments(Request(ids=ids), 0) == [ids[:11], ids[11:]]
    (req,) = _reqs([40], base_seed=30)
    (out,) = eng.synthesize([req])
    segs = eng._segments(req, 0)
    assert len(segs) == 3 and sum(map(len, segs)) == 40
    assert out.wav is None and out.mel.shape == (out.n_frames, 10)
    (trunc,) = TTSEngine(tfs2, overflow="truncate", **kw).synthesize([req])
    assert 0 < trunc.n_frames <= 16 * 4
    with pytest.raises(ValueError, match="exceeds the largest"):
        TTSEngine(tfs2, overflow="error", **kw).synthesize([req])
    with pytest.raises(ValueError, match="overflow"):
        TTSEngine(tfs2, overflow="bogus", **kw)
    with pytest.raises(ValueError, match="empty"):
        eng.synthesize([Request(ids=[])])


def test_engine_routes_speakers(models):
    """multi_speaker passes each request's spk_id into the AM."""
    *_, tfs2, _, _, _ = models
    eng = TTSEngine(tfs2, text_buckets=(8,), batch_buckets=(2,),
                    frames_per_token=4, multi_speaker=True)
    ids = _reqs([6])[0].ids
    a, b = eng.synthesize([Request(ids=ids, spk_id=0),
                           Request(ids=ids, spk_id=2)])
    assert a.mel.shape[1] == b.mel.shape[1] == 10
    assert not np.allclose(a.mel[:min(a.n_frames, b.n_frames)],
                           b.mel[:min(a.n_frames, b.n_frames)])
