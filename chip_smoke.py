"""Smoke run of the PyTorch/CUDA port (``parakeet_tpu_torch``) on one GPU.

Run from the root of the repository on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each (the checks raise; nothing is caught):

1. the card (``nvidia-smi``: name and power limit) and the build of the
   port's CUDA kernels from ``parakeet_tpu_torch/csrc``;
2. kernel K1 (the fused Parallel WaveGAN residual stack) against its plain
   PyTorch version, at a small shape and at the main shape (B=1,
   T=268,800, 30 layers, the widths of recipes/pwgan/conf/default.yaml):
   max abs error against a stated tolerance, and median times;
3. the slice: a port ``TTSEngine`` on bf16 FastSpeech2 and PWGGenerator at
   the recipes' widths with weights drawn from a fixed ``torch.Generator``
   seed answers six requests (one over the largest text bucket, so it is
   split); every wav must be finite with ``n_frames * 300`` samples, K1
   must have launched once per layer for every chunk, and one request
   must give the same wav alone and inside a batch, and agree with the
   wav of the eager residual stack (no kernel) within a stated tolerance.

The line before the last is a JSON object with each kernel's launches on
the main path, error and times; the last line is the run's result.
Without a CUDA device it raises and prints no result.
"""
import json
import math
import statistics
import subprocess
import time

import torch

SEED = 0
SAMPLE_RATE = 24000                 # recipes/*/conf/default.yaml fs
IDIM = 80                           # phone vocabulary, as bench.py uses
ODIM = 80                           # n_mels
# recipes/fastspeech2/conf/default.yaml `model`, without init_type
FS2_CONFIG = dict(
    adim=384, aheads=2, elayers=4, eunits=1536, dlayers=4, dunits=1536,
    positionwise_layer_type="conv1d", positionwise_conv_kernel_size=3,
    duration_predictor_layers=2, duration_predictor_chans=256,
    duration_predictor_kernel_size=3, postnet_layers=5, postnet_filts=5,
    postnet_chans=256, use_scaled_pos_enc=True, reduction_factor=1)
# recipes/pwgan/conf/default.yaml `generator_params`, without stack_impl
PWG_CONFIG = dict(
    layers=30, stacks=3, residual_channels=64, gate_channels=128,
    skip_channels=64, aux_context_window=2, upsample_scales=[4, 5, 3, 5])
TEXT_BUCKETS = (32, 64, 128)
BATCH_BUCKETS = (1, 2, 4)
FRAMES_PER_TOKEN = 7                # 128 tokens -> 896 frames, as bench.py
REQUEST_LENGTHS = (20, 45, 77, 100, 128, 150)
MAIN_T = 268800                     # 896 frames * hop 300
SMALL = (2, 3000)                   # (B, T) of the small K1 check
# the random AM's log-durations are centred on log(5) with a spread of
# about 0.25: ~4 frames (~50 ms at hop 300 / 24 kHz) per phone, so that
# utterances have a speech-like length within the 7-frame capacity
DURATION_BIAS, DURATION_SPREAD = math.log(5.0), 0.25

# K1 against its plain version: both round at the same points and differ
# only in the order of float32 sums, which now and then flips a bf16
# rounding (2^-8 relative) of h or of x at a group end; such flips carried
# through the remaining layers stay within 2^-5 of the output's range.
K1_REL_TOL = 2 ** -5
# batch invariance: noise rows depend on the request seed only, and K1
# works per batch item, but the AM's bf16 GEMMs take other shapes in a
# batch, so activations may differ by a bf16 ulp; 2^-4 of the wav's range
# bounds that after the vocoder.  Durations must match exactly.
INVARIANCE_REL_TOL = 2 ** -4
# K1 against the eager stack: the eager loop rounds x to bf16 after every
# layer, K1 only at group ends, so their wavs differ by about 1% of the
# range (measured at these widths on the CPU); 2^-4 still fails a wrong
# tap, weight or bias layout, which changes the wav entirely
REFERENCE_REL_TOL = 2 ** -4


def seeded_init_(module, gen):
    """Stand-in for trained weights, drawn from ``gen``: biases N(0, 0.02),
    scales (LayerNorm, BatchNorm, weight norm) and alphas 1, every other
    tensor N(0, 1 / fan_in) with fan_in the size of one output row."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            elif leaf.endswith("scale") or leaf == "alpha" or p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(p[0].numel()))


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from parakeet_tpu_torch.ops.kernels._build import load_library
    t0 = time.perf_counter()
    lib = load_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path}; "
          + " | ".join(ptxas))


def phase_k1():
    """K1 against its plain version; returns the kernel record."""
    from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    gen = torch.Generator().manual_seed(SEED + 1)
    stack = ResidualStack(**{k: PWG_CONFIG[k] for k in (
        "layers", "stacks", "residual_channels", "gate_channels",
        "skip_channels")}, aux_channels=ODIM)
    seeded_init_(stack, gen)
    stack = stack.cuda()
    weights = stack.fused_weights()
    kw = dict(dilations=stack.dilations(), stacks=stack.stacks)
    record = None
    for b, t in (SMALL, (1, MAIN_T)):
        x = torch.randn((b, t, 64), generator=gen).cuda()
        c = torch.randn((b, t, ODIM), generator=gen).cuda()
        got_x, got_s = k1.fused_residual_stack(x, c, weights, **kw)
        ref_x, ref_s = k1.fused_residual_stack_reference(x, c, weights, **kw)
        torch.cuda.synchronize()
        errs = []
        for name, got, ref in (("x", got_x, ref_x), ("skip", got_s, ref_s)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = K1_REL_TOL * max(1.0, ref.float().abs().max().item())
            if not err <= tol:
                raise AssertionError(f"K1 {name} at B={b} T={t}: max abs err "
                                     f"{err} > tol {tol}")
            errs.append((name, err, tol))
        ms = cuda_ms(lambda: k1.fused_residual_stack(x, c, weights, **kw), 20)
        plain_ms = cuda_ms(
            lambda: k1.fused_residual_stack_reference(x, c, weights, **kw), 5)
        print(f"K1 B={b} T={t}: " + ", ".join(
            f"{n} max_abs_err {e:.6g} (tol {tl:.6g})" for n, e, tl in errs)
            + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median)")
        record = {"name": "pwg_residual_stack", "route": "cuda",
                  "source": "parakeet_tpu_torch/csrc/pwg_stack.cu",
                  "replaces": "parakeet_tpu/ops/pallas/pwg_stack.py:84",
                  "max_abs_err": max(e for _, e, _ in errs),
                  "ms": ms, "plain_ms": plain_ms}
    return record


def build_engine():
    from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
    from parakeet_tpu_torch.ops.normalizer import ZScore
    from parakeet_tpu_torch.serving import TTSEngine
    gen = torch.Generator().manual_seed(SEED)
    am = FastSpeech2(IDIM, ODIM, **FS2_CONFIG)
    voc = PWGGenerator(**PWG_CONFIG)
    seeded_init_(am, gen)
    seeded_init_(voc, gen)
    with torch.no_grad():
        am.duration_predictor.stack.linear.weight.mul_(DURATION_SPREAD)
        am.duration_predictor.stack.linear.bias.fill_(DURATION_BIAS)
    am = am.to("cuda", torch.bfloat16).eval()
    voc = voc.to("cuda", torch.bfloat16).eval()
    am_norm = ZScore(torch.randn(ODIM, generator=gen) - 5.0,
                     torch.rand(ODIM, generator=gen) + 0.5)
    voc_norm = ZScore(am_norm.mu + 0.1, am_norm.sigma * 1.1)
    return TTSEngine(am, voc=voc, am_norm=am_norm, voc_norm=voc_norm,
                     text_buckets=TEXT_BUCKETS, batch_buckets=BATCH_BUCKETS,
                     frames_per_token=FRAMES_PER_TOKEN)


def phase_slice(record):
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.serving import Request

    engine = build_engine()
    chunks = []

    def run_chunk(chunk, tb, out, _inner=engine._run_chunk):
        n0 = k1.fused_residual_stack.launches
        t0 = time.perf_counter()
        _inner(chunk, tb, out)          # ends with the host copy of audio
        wall = time.perf_counter() - t0
        samples = sum(out[i].wav.size for i, _ in chunk)
        chunks.append((tb, len(chunk), wall, samples / SAMPLE_RATE,
                       k1.fused_residual_stack.launches - n0))

    engine._run_chunk = run_chunk
    engine.warmup()                     # first use of every grid point
    chunks.clear()
    gen = torch.Generator().manual_seed(SEED + 2)
    reqs = [Request(ids=torch.randint(1, IDIM, (n,), generator=gen).tolist(),
                    utt_id=f"u{i}", seed=100 + i)
            for i, n in enumerate(REQUEST_LENGTHS)]
    k1.fused_residual_stack.launches = 0
    results = engine.synthesize(reqs)
    launches = k1.fused_residual_stack.launches
    per_stack = PWG_CONFIG["layers"]
    for tb, n, wall, audio_s, n_launch in chunks:
        print(f"chunk text_bucket={tb} requests={n}: audio {audio_s:.4f} s, "
              f"wall {wall:.4f} s, K1 launches {n_launch}")
        if n_launch != per_stack:
            raise AssertionError(f"chunk launched K1 {n_launch} times, not "
                                 f"{per_stack}")
    n_chunks = len(chunks)
    if launches != per_stack * n_chunks or launches == 0:
        raise AssertionError(f"K1 launches {launches} for {n_chunks} "
                             f"chunks")
    hop = engine.hop
    for req, res in zip(reqs, results):
        if res.wav.shape != (res.n_frames * hop,) or res.n_frames <= 0:
            raise AssertionError(f"{req.utt_id}: wav {res.wav.shape} for "
                                 f"{res.n_frames} frames")
        if not torch.isfinite(torch.from_numpy(res.wav)).all():
            raise AssertionError(f"{req.utt_id}: non-finite samples")
    (solo,) = engine.synthesize([reqs[0]])
    batched = results[0]
    if solo.n_frames != batched.n_frames:
        raise AssertionError(f"batch invariance: {solo.n_frames} frames "
                             f"alone, {batched.n_frames} in a batch")
    diff = float(abs(solo.wav - batched.wav).max())
    tol = INVARIANCE_REL_TOL * max(1e-3, float(abs(batched.wav).max()))
    if not diff <= tol:
        raise AssertionError(f"batch invariance: max abs diff {diff} > {tol}")
    # reference: the same request with the stack on the eager layer loop
    # (the JAX package's 'xla' path, no kernel); the AM runs the same
    # shapes, so only the vocoder's rounding differs
    engine.voc.stack.impl = "eager"
    n0 = k1.fused_residual_stack.launches
    (eager,) = engine.synthesize([reqs[0]])
    engine.voc.stack.impl = "auto"
    if k1.fused_residual_stack.launches != n0:
        raise AssertionError("the eager stack launched K1")
    ref_diff = float(abs(solo.wav - eager.wav).max())
    ref_tol = REFERENCE_REL_TOL * max(1e-3, float(abs(eager.wav).max()))
    if eager.n_frames != solo.n_frames or not ref_diff <= ref_tol:
        raise AssertionError(f"against the eager stack: {eager.n_frames} "
                             f"frames, max abs diff {ref_diff} > {ref_tol}")
    print(f"slice: {len(reqs)} requests, {n_chunks} chunks, "
          f"frames {[r.n_frames for r in results]}, all finite; "
          f"K1 launches {launches}; batch invariance max abs diff "
          f"{diff:.6g} (tol {tol:.6g}); against the eager stack max abs "
          f"diff {ref_diff:.6g} (tol {ref_tol:.6g})")
    record["launches"] = launches
    return record


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    record = phase_slice(phase_k1())
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
