"""The port's synthesis benchmarks and their accounting, on the CPU:
``utils/flops.py`` (the FLOP count against a hand count and against the
JAX package's, and MFU against the card's bf16 peak), each benchmark's
``main(argv)`` on ``--device cpu`` at tiny widths, and the latency
simulator on a fake engine with fixed service times.  Times and MFU are
the card's and come from chip runs only; here their keys are checked.
Every bench twin turns TF32 off (cuBLAS's and cuDNN's float32 products
as float32, as ``chip_smoke.py`` runs) and records ``tf32`` False, from
flags set True before its ``main``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import FastSpeech2 as JFS2
from parakeet_tpu.models import PWGGenerator as JPWG
from parakeet_tpu.utils import flops as jflops
from parakeet_tpu_torch.benchmarks import (common, e2e_rtf, longform_rtf,
                                           serving_engine, serving_latency,
                                           serving_throughput)
from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
from parakeet_tpu_torch.utils import flops

torch.set_num_threads(1)

FS2 = dict(idim=30, odim=10, adim=16, aheads=2, elayers=2, eunits=32,
           dlayers=2, dunits=32, postnet_layers=2, postnet_chans=8,
           postnet_filts=5, duration_predictor_chans=16,
           pitch_predictor_chans=16, energy_predictor_chans=16,
           positionwise_layer_type="conv1d",
           positionwise_conv_kernel_size=3)
PWG = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
           skip_channels=32, aux_channels=10, aux_context_window=1,
           upsample_scales=(2, 2))
B, T, F, HOP = 2, 12, 32, 4   # batch, phone ids, frames, hop
H100 = "NVIDIA H100 80GB HBM3"
# bench.py's JSON keys, and what the port's synthesis benchmarks add
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "dtype",
              "achieved_tflops", "mfu_pct"}
NEW_KEYS = {"peak_tflops", "backend", "device", "power_limit", "graph_ms",
            "eager_ms", "attn_impl"}


# the FastSpeech2 and PWGGenerator defaults that the hand count reads
FS2_DEFAULTS = dict(positionwise_conv_kernel_size=1, postnet_layers=5,
                    postnet_chans=512, postnet_filts=5,
                    duration_predictor_chans=384, pitch_predictor_chans=384,
                    energy_predictor_chans=384)
PWG_DEFAULTS = dict(aux_channels=80)


def _hand_flops(fs2c, pwgc, b, t, f):
    """The products and convolutions of FS2 -> edge pad -> PWG, by hand, as
    the port forms them: (all, the residual stack's share)."""
    fs2c, pwgc = {**FS2_DEFAULTS, **fs2c}, {**PWG_DEFAULTS, **pwgc}
    d, k = fs2c["adim"], fs2c["positionwise_conv_kernel_size"]

    def layer(n, units):        # q, k, v, out; scores and context; FFN
        return (4 * 2 * b * n * d * d + 2 * 2 * b * n * n * d
                + 2 * 2 * b * n * d * units * k)

    n = fs2c["elayers"] * layer(t, fs2c["eunits"])
    n += fs2c["dlayers"] * layer(f, fs2c["dunits"])
    for c in (fs2c["duration_predictor_chans"],
              fs2c["pitch_predictor_chans"],
              fs2c["energy_predictor_chans"]):   # two k=3 convs, a linear
        n += 2 * b * t * 3 * (d * c + c * c) + 2 * b * t * c
    n += 2 * 2 * b * t * d * 9                  # pitch, energy embeddings
    n += 2 * b * f * d * fs2c["odim"]           # feat_out
    c, o, L = fs2c["postnet_chans"], fs2c["odim"], fs2c["postnet_layers"]
    n += 2 * b * f * fs2c["postnet_filts"] * (o * c + (L - 2) * c * c
                                              + c * o)
    a, w = pwgc["aux_channels"], pwgc["aux_context_window"]
    n += 2 * b * f * a * a * (2 * w + 1)        # conv_in, VALID
    m = f
    for s in pwgc["upsample_scales"]:
        # the polyphase product, and the phase taps' (3, 2s+1) x (2s+1)
        # einsum (the outer product that builds its matrix counts 0)
        n += 2 * b * m * 3 * a * s * a + 2 * 3 * (2 * s + 1) * s
        m *= s
    samples = m                                 # f x hop
    cr, cg, cs = (pwgc["residual_channels"], pwgc["gate_channels"],
                  pwgc["skip_channels"])
    stack = pwgc["layers"] * 2 * b * samples * (3 * cr * cg + a * cg
                                                + cg // 2 * (cs + cr))
    n += stack + 2 * b * samples * (cr + cs * cs + cs)  # first, last convs
    return n, stack


def _inputs():
    rng = np.random.default_rng(0)
    text = rng.integers(1, FS2["idim"], (B, T))
    lengths = np.array([T, 7])
    return text, lengths


def test_synthesis_flops_match_a_hand_count():
    """Exactly, with the stack's kernel route ('fused') and the flash core
    asked for: the count runs the eager stack and the dense core, and
    restores both."""
    fs2 = FastSpeech2(**FS2, attn_impl="flash").eval()
    pwg = PWGGenerator(stack_impl="fused", **PWG)
    text, lengths = map(torch.from_numpy, _inputs())
    got = flops.fs2_pwg_synthesis_flops(
        fs2, pwg, text, lengths, torch.randn(B, F * HOP, 1), max_frames=F)
    assert got == _hand_flops(FS2, PWG, B, T, F)[0]
    assert pwg.stack.impl == "fused"
    assert fs2.encoder.layer_0.self_attn.attn_core is not None


def test_bench_widths_flops_are_the_stack_and_a_little_more():
    """At bench.py's widths (8 phone ids, 16 frames: 4,800 samples), the
    count equals the hand count, and its residual stack is chip_smoke.py's
    86,016 FLOPs a sample and layer over 30 layers: the sum behind
    e2e_rtf's ~0.69 TFLOP of stack at 268,800 samples, the rest of the
    program ~6% beside it there."""
    import chip_smoke
    fs2 = FastSpeech2(**common.FS2_CONFIG).eval()
    pwg = PWGGenerator(**common.PWG_CONFIG)
    text = torch.ones((1, 8), dtype=torch.int64)
    got = flops.fs2_pwg_synthesis_flops(
        fs2, pwg, text, torch.tensor([8]), torch.zeros(1, 16 * 300, 1),
        max_frames=16)
    want, stack = _hand_flops(common.FS2_CONFIG, common.PWG_CONFIG, 1, 8, 16)
    assert got == want
    assert stack == chip_smoke.STACK_FWD_FLOPS * 30 * 16 * 300
    assert chip_smoke.STACK_FWD_FLOPS == 86016


def test_synthesis_flops_against_the_jax_count():
    """Against the JAX package's count (XLA's cost model of the pure-XLA
    program) at the same widths: XLA counts every product the port counts
    and elementwise work besides (1 FLOP an element: biases, gates,
    norms, softmax), 4.2% more here, so the port's count is held to
    [0.9, 1] of it."""
    text, lengths = map(jnp.asarray, _inputs())
    jfs2, jpwg = JFS2(**FS2), JPWG(**PWG)
    fv = jax.jit(lambda k: jfs2.init(
        {"params": k}, text, lengths, max_frames=F,
        method=JFS2.inference))(jax.random.PRNGKey(0))
    noise = jnp.zeros((B, F * HOP, 1))
    pv = jax.jit(jpwg.init)(jax.random.PRNGKey(1), noise,
                            jnp.zeros((B, F + 2, 10)))
    want = jflops.fs2_pwg_synthesis_flops(jfs2, jpwg, fv, pv["params"],
                                          text, lengths, noise,
                                          max_frames=F)
    ratio = _hand_flops(FS2, PWG, B, T, F)[0] / want
    assert 0.9 <= ratio <= 1.0, ratio


def test_mfu_is_taken_against_the_bf16_peak():
    """MFU divides by the H100's 989 TFLOP/s of dense bf16 whatever the
    program's dtype (kernel K1 forms bf16 products in a float32 program
    too): there is no float32 peak to divide by; the CPU has no peak."""
    assert flops.chip_peak_flops(H100) == 989e12
    assert flops.chip_peak_flops("cpu") is None
    stats = flops.mfu_stats(0.69e12, 5e-3, H100)
    assert stats["peak_tflops"] == 989.0
    assert stats["achieved_tflops"] == pytest.approx(138.0)
    assert stats["mfu_pct"] == pytest.approx(100 * 138e12 / 989e12)
    assert flops.mfu_stats(0.69e12, 5e-3, "cpu")["mfu_pct"] is None
    assert flops.mfu_stats(None, 5e-3, H100)["mfu_pct"] is None


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA A100-SXM4-80GB"])
def test_other_cards_have_no_peak(name):
    """Only the H100 SXM's full name has the 989 TFLOP/s peak: the PCIe
    and NVL H100s have lower dense bf16 peaks, so their MFU is None
    rather than read against the SXM's."""
    assert flops.chip_peak_flops(name) is None
    assert flops.mfu_stats(0.69e12, 5e-3, name)["mfu_pct"] is None


@pytest.fixture
def tiny(monkeypatch):
    """bench.py's models cut to a few narrow layers (idim and odim stay
    80: the workloads draw ids below 80)."""
    monkeypatch.setattr(common, "FS2_CONFIG", dict(
        idim=80, odim=80, adim=16, aheads=2, elayers=1, eunits=16,
        dlayers=1, dunits=16, postnet_chans=8, duration_predictor_chans=8,
        pitch_predictor_chans=8, energy_predictor_chans=8))
    monkeypatch.setattr(common, "PWG_CONFIG", dict(
        layers=2, stacks=1, residual_channels=32, gate_channels=64,
        skip_channels=32, upsample_scales=(2, 2), aux_context_window=1))
    monkeypatch.setattr(e2e_rtf, "TEXT_LEN", 8)
    monkeypatch.setattr(e2e_rtf, "MAX_FRAMES", 32)
    monkeypatch.setattr(longform_rtf, "TEXT_LEN", 8)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (cuDNN's is on by default), as a process may
    leave them; a bench's ``main`` must turn them off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def _tf32_off(*records):
    assert records and all(r["tf32"] is False for r in records)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _cpu_record(rec):
    assert rec["backend"] == rec["device"] == "cpu"
    assert rec["power_limit"] is None and rec["graph_ms"] is None
    assert rec["mfu_pct"] is None and rec["achieved_tflops"] is None
    assert rec["replay_kernels"] is None and rec["replay_busy_ms"] is None
    assert rec["eager_ms"] > 0 and rec["value"] > 0
    assert rec["flops"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e2e_rtf_main_on_the_cpu(tiny, tf32_on, capsys, dtype):
    rec = e2e_rtf.main(["--device", "cpu", "--iters", "1", "--dtype", dtype,
                        "--attn-impl", "dense"])
    assert BENCH_KEYS | NEW_KEYS <= set(rec)
    assert rec["metric"] == "fastspeech2_pwgan_e2e_rtf"
    assert rec["vs_baseline"] is None and rec["dtype"] == dtype
    assert rec["audio_seconds"] == 32 * 4 / 24000
    _cpu_record(rec)
    _tf32_off(rec)
    assert capsys.readouterr().out.count("\n") == 1


def test_serving_throughput_main_on_the_cpu(tiny, tf32_on):
    rec = serving_throughput.main(["--device", "cpu", "--iters", "1",
                                   "--batch-size", "2", "--text-len", "6",
                                   "--max-frames", "24"])
    # benchmarks/serving_throughput.py's keys: bench.py's but vs_baseline
    assert (BENCH_KEYS - {"vs_baseline"}) | NEW_KEYS | {
        "batch_size", "per_stream_rtf"} <= set(rec)
    assert rec["unit"] == "audio_seconds/sec" and rec["batch_size"] == 2
    assert rec["audio_seconds"] == 2 * 24 * 4 / 24000
    _cpu_record(rec)
    _tf32_off(rec)


def test_longform_rtf_main_on_the_cpu(tiny, tf32_on):
    recs = longform_rtf.main(["--device", "cpu", "--iters", "1",
                              "--frames", "40"])
    assert [r["attn_impl"] for r in recs] == ["dense", "auto"]
    for rec in recs:
        # benchmarks/longform_rtf.py's keys, with the dtype
        assert (BENCH_KEYS - {"vs_baseline"}) | NEW_KEYS | {
            "frames", "audio_seconds"} <= set(rec)
        assert rec["frame_lengths"] == [40]
        _cpu_record(rec)
    _tf32_off(*recs)


def test_serving_engine_main_on_the_cpu(tiny, tf32_on):
    rec = serving_engine.main(["--device", "cpu", "--requests", "5",
                               "--min-len", "3", "--buckets", "8", "16",
                               "--batch-size", "2", "--frames-per-token",
                               "4", "--repeats", "1"])
    assert rec["metric"] == "tts_engine_mixed_workload_throughput"
    assert rec["programs"] >= 1 and rec["value"] > 0
    assert rec["pad_to_max_value"] > 0 and rec["bucketing_speedup"] > 0
    assert rec["graphs"] is False and rec["eager_value"] is None
    assert rec["graph_reserved_gib"] is None and rec["device"] == "cpu"
    _tf32_off(rec)


def test_serving_latency_main_on_the_cpu(tiny, tf32_on):
    recs = serving_latency.main(["--device", "cpu", "--rates", "50",
                                 "--requests", "4", "--min-len", "3",
                                 "--buckets", "8", "--batch-size", "2",
                                 "--frames-per-token", "4"])
    (rec,) = recs
    assert rec["metric"] == "serving_latency" and rec["graphs"] is False
    assert 0 < rec["p50_ms"] <= rec["p95_ms"] <= rec["p99_ms"]
    assert 1 <= rec["mean_batch"] <= 2 and 0 < rec["utilization"] <= 1
    _tf32_off(rec)


def _family_twins(monkeypatch):
    from parakeet_tpu_torch.benchmarks import (ar_decode, e2e_family_rtf,
                                               train_am, waveflow_rtf)
    from test_torch_family_recipes import (SS_SMALL, T2_SMALL, TT_SMALL,
                                           WF_SMALL)
    for mod in (e2e_family_rtf, train_am, ar_decode):
        monkeypatch.setattr(mod, "MODEL_CONFIGS", {
            "tacotron2": T2_SMALL, "speedyspeech": SS_SMALL,
            "transformer_tts": TT_SMALL, "waveflow": WF_SMALL})
    monkeypatch.setattr(e2e_family_rtf, "PWG_CONFIG", dict(
        layers=2, stacks=1, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_context_window=2))
    for mod in (e2e_family_rtf, ar_decode):
        monkeypatch.setattr(mod, "TEXT_LEN", 8)
    monkeypatch.setattr(e2e_family_rtf, "FRAMES", 6)
    monkeypatch.setattr(train_am, "WAVEFLOW_FRAMES", 6)
    monkeypatch.setattr(waveflow_rtf, "MODEL_CONFIG", WF_SMALL)
    return {
        "e2e_family_rtf": lambda: e2e_family_rtf.main([
            "--device", "cpu", "--iters", "1", "--warmup", "0",
            "--families", "speedyspeech"]),
        "ar_decode": lambda: ar_decode.main([
            "--device", "cpu", "--steps", "3", "--iters", "1", "--warmup",
            "0", "--models", "transformer_tts"]),
        "waveflow_rtf": lambda: waveflow_rtf.main([
            "--device", "cpu", "--iters", "1", "--frames", "5"]),
        "train_am": lambda: train_am.main([
            "--device", "cpu", "--iters", "1", "--batch-size", "2",
            "--text-len", "8", "--frames", "24", "--models",
            "speedyspeech"])}


def _train_twins(monkeypatch):
    from parakeet_tpu_torch.benchmarks import (ge2e_train, train_fastspeech2,
                                               train_pwgan)
    from test_torch_recipe import TINY_OPTS
    monkeypatch.setattr(ge2e_train, "MODEL_CONFIG", dict(
        num_layers=1, hidden_size=8, output_size=8))
    return {
        "train_pwgan": lambda: train_pwgan.main([
            "--device", "cpu", "--batch-sizes", "1", "--iters", "1",
            "--opts", *TINY_OPTS]),
        "train_fastspeech2": lambda: train_fastspeech2.main([
            "--device", "cpu", "--iters", "1", "--batch-size", "2",
            "--text-len", "8", "--frames", "24"]),
        "ge2e_train": lambda: ge2e_train.main([
            "--device", "cpu", "--iters", "1", "--speakers", "2", "--utts",
            "2", "--frames", "8", "--n-mels", "8"])}


@pytest.mark.parametrize("name", [
    "e2e_family_rtf", "ar_decode", "waveflow_rtf", "train_am",
    "train_pwgan", "train_fastspeech2", "ge2e_train"])
def test_other_bench_twins_turn_tf32_off(name, monkeypatch, tf32_on):
    """The bench twins outside this file's synthesis benches (their own
    tests are in test_torch_family_recipes.py, test_torch_recipe.py,
    test_torch_fs2_recipe.py and test_torch_ge2e_recipes.py), each at
    tiny widths on the CPU: TF32 off and ``tf32`` False in every
    record."""
    twins = {**_family_twins(monkeypatch), **_train_twins(monkeypatch)}
    out = twins[name]()
    _tf32_off(*(out if isinstance(out, list) else [out]))


class _FakeEngine:
    """Each synthesize takes ``service`` seconds of a fake clock."""

    def __init__(self, service):
        self.now, self.service, self.batches = 0.0, service, []

    def clock(self):
        return self.now

    def synthesize(self, batch):
        self.batches.append(len(batch))
        self.now += self.service


def test_latency_simulator_by_hand():
    """A 0.1 s service.  At 0.001 requests/s every request is served alone
    the moment it arrives: each latency is 0.1 s.  At 10^6 requests/s with
    a 1 s window and batches of 4, the eight requests arrive within
    microseconds: the first four complete 1.1 s after they arrive, the
    last four wait for the first batch (done at 1.1 s) and a second window
    and complete at 2.2 s; p50 interpolates between the 4th and 5th
    latencies, 1.65 s, and p99 is 2.2 s; busy 0.2 of 2.2 s."""
    reqs = list(range(8))
    slow = _FakeEngine(0.1)
    lat, sizes, util = serving_latency.simulate(slow, reqs, 1e-3, 0.0, 4,
                                                clock=slow.clock)
    np.testing.assert_allclose(lat, 0.1, rtol=0, atol=1e-9)
    assert sizes == [1] * 8 and slow.batches == sizes
    fast = _FakeEngine(0.1)
    lat, sizes, util = serving_latency.simulate(fast, reqs, 1e6, 1.0, 4,
                                                clock=fast.clock)
    assert sizes == [4, 4]
    assert np.percentile(lat, 50) == pytest.approx(1.65, abs=1e-4)
    assert np.percentile(lat, 99) == pytest.approx(2.2, abs=1e-4)
    assert util == pytest.approx(0.2 / 2.2, abs=1e-4)


@pytest.mark.parametrize("n_keys", [128, 357, 1024, 6144])
def test_k4a_graph_tolerance_is_the_summation_bound(n_keys):
    """chip_smoke.py's K4a tolerance at the graphs' shapes: in float32 the
    recursive-summation bound n * 2^-24, which is K4_REL_TOL's 2^-14 up
    to the training step's 1,024 keys; in bf16 K4_REL_TOL itself."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tol = smoke.k4a_graph_tol(torch.float32, n_keys)
    assert tol == max(2 ** -14, n_keys * 2 ** -24)
    assert (tol == smoke.K4_REL_TOL["float32"]) == (n_keys <= 1024)
    assert smoke.k4a_graph_tol(torch.bfloat16, n_keys) == 2 ** -7
