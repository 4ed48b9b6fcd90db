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
3. the serving slice: a port ``TTSEngine`` on bf16 FastSpeech2 and
   PWGGenerator at the recipes' widths with weights drawn from a fixed
   ``torch.Generator`` seed answers six requests (one over the largest
   text bucket, so it is split); every wav must be finite with
   ``n_frames * 300`` samples, K1 must have launched once per layer for
   every chunk, and one request must give the same wav alone and inside a
   batch, and agree with the wav of the eager residual stack (no kernel)
   within a stated tolerance;
4. kernels K2a/K2b (the residual stack's training forward and backward,
   one group of ten layers) and K3a/K3b/K3c (discriminator layers 1..9:
   forward, backward from the saved layer inputs, backward that rebuilds
   them from the layer-0 output) against their plain PyTorch versions, at
   a small shape and at the training shape (B=8, T=25,500: the PWGAN
   recipe's batch_size and batch_max_steps): max abs errors against
   stated tolerances, gradients bit-identical from run to run, K3c's dh
   bitwise K3b's and its dW and db within a stated tolerance of K3b's,
   median times (also of K3a without saving + K3c against K3a saving +
   K3b);
5. the training slice: a port ``Trainer`` over ``StandardUpdater`` runs
   the PWGAN GAN step of recipes/pwgan/conf/default.yaml for four steps at
   its full widths on seeded synthetic (wav, mel) batches, with
   discriminator_train_start_steps=2, so steps 0-1 run the discriminator-
   off program and steps 2-3 the GAN program.  Every metric must be
   finite, the parameters must move, each kernel must launch the expected
   number of times per step, the residual stack, first conv and upsampler
   must get non-zero gradients, and step 0 must agree with the same step
   on the eager impls (no kernel) within stated tolerances.  It prints ms
   per step with the kernels and with the eager impls;
6. kernel K4 (flash attention: forward K4a, dK/dV pass K4b, dQ pass K4c)
   against its plain PyTorch versions in float32 and bf16, at a small
   shape (B=2, T=200, H=2, dk=32, key lengths 200 and 131, with query
   rows masked as well, jax's segment rule) and at both shapes of the
   FastSpeech2 training step (B=16, H=4, dk=96: the encoder's T=64, key
   lengths 48-64, and the decoder's T=1024, key lengths 700-1024): max
   abs errors against stated tolerances, gradients bit-identical from run
   to run, median times of the forward and of forward + backward;
7. the FastSpeech2 training slice: two port ``Trainer``s run four steps
   each of the FastSpeech2 model of benchmarks/flash_sweep.py (adim 384,
   4 heads, 4 + 4 layers, float32, Adam 1e-4) at its 1024-frame point
   (B=16, 64 tokens) on seeded synthetic batches of varied lengths, one
   with attn_impl='flash' and one with 'dense', from the same weights and
   generator seed.  Every metric must be finite, every submodule's
   parameters and the BatchNorm statistics must move, K4a, K4b and K4c
   must each launch 8 times per step in the flash run (4 encoder + 4
   decoder layers) and never in the dense run, and step 0 must agree
   between the two within stated tolerances.  It prints ms per step for
   both; then ``inference(max_frames=1024)`` of the trained flash model
   (K4a under no_grad) must agree with a dense copy of it;
8. the PWGAN recipe through its CLI (``parakeet_tpu_torch.recipes.pwgan.
   train.main``, on the card by default) with recipes/pwgan/conf/
   default.yaml at full widths and ``discriminator_params.vjp_mode
   recompute``, on a seeded synthetic dump in the recipe's format under
   build/: 4 steps (the discriminator from step 2, evaluation and a
   snapshot every 2, 2 snapshots kept), a second run to 6 that must resume
   from the newest snapshot at iteration 4 (an epoch boundary) and run
   steps 4-5 only, and a straight 6-step run from an empty directory whose
   last metrics must equal the resumed run's bitwise.  Every step must
   launch the expected kernels (K3c, never K3b; K3a never saving), every
   train and eval metric must be finite, and each run must leave its 2
   newest snapshots and their ledger;
9. the training bench (``parakeet_tpu_torch.benchmarks.train_pwgan``) at
   batch 6 with ``--disc-vjp save`` and ``recompute`` in turns: its
   ``pwgan_train_avg_ips`` for both.

The line before the last is a JSON object with each kernel's launches on
its path (K1: serving; K2a-K3b: PWGAN training; K3c: the recipe's runs;
K4a-K4c: FastSpeech2 training), error, times, bound (the larger of its
bytes over the H100's memory rate and its operations over its peak for
the operands' type, from this run's shapes) and, where one PyTorch call
computes the same function, that call's time; the last line is the run's
result.  Without a CUDA device it raises and prints no result.
``--profile DIR`` also writes ``torch.profiler`` tables of one GAN step
with the kernels and of one FastSpeech2 step with flash attention to DIR.
"""
import argparse
import json
import math
import pathlib
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
# recipes/pwgan/conf/default.yaml: discriminator_params without impl,
# batch_size, batch_max_steps, the optimizers, updater and STFT losses
DISC_CONFIG = dict(layers=10, conv_channels=64)
TRAIN_B, TRAIN_T = 8, 25500
GEN_LR, DISC_LR = 1e-4, 5e-5
LAMBDA_ADV = 4.0
STFT_LOSS = dict(fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240))
TRAIN_STEPS, DISC_START = 4, 2
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
# K2a/K2b and K3a/K3b against their plain versions on the card: both
# round at the same points and differ in the order of float32 sums (and
# the kernels' fast tanh and sigmoid), which now and then flips a bf16
# rounding of an operand (2^-8 relative) and carries it through the
# group's ten layers (the discriminator's nine); 2^-5 of each output's
# range bounds that, as for K1.  A wrong tap, weight block or reduction
# is off by the whole range.
K2_REL_TOL = K3_REL_TOL = 2 ** -5
# K3c against its plain version: each rebuilds the layer inputs from h,
# the kernel with K3a's float32 sum order and the plain version with
# cuBLAS's, so now and then a pre-activation near zero takes the other
# LeakyReLU slope (a factor 5 on its dpre) and a few rows of dh move by
# up to ~10% of dh's range (emulated on the CPU by summing the plain
# forward in another order: 6.7% at B=2, T=3,000 and 9.0% at B=4,
# T=25,500, 1.6-1.8% in relative L2).  Held in relative L2, 2^-4; its
# arithmetic is pinned by the checks against K3b below, and K3b's against
# its plain version on shared streams.
K3C_REL_L2 = 2 ** -4
# K3c against K3b on K3a's saved streams: K3c rebuilds the streams with
# K3a's code (bitwise equal) and runs K3b's reverse pass, so dh must be
# bitwise K3b's; dW and db sum the same float32 terms grouped by tile
# instead of by chunk of rows, 2^-14 of their range (measured 1.4e-6 of
# dW's range at the training shape)
K3C_VS_K3B_REL_TOL = 2 ** -14
# step 0 with the kernels against step 0 on the eager impls (float32, no
# kernel).  The kernels' bf16 operands move the fake by ~1% of its range
# (as the serving wav), which moves the STFT losses by less than 2^-5 of
# their value.  The stack weights' gradient is compared through the
# spectral-convergence term: the log-magnitude term's gradient at a random
# generator is dominated by near-silent STFT bins, and moving the fake by
# 1e-3 of its range alone changes it by 116% in relative L2 (float64 on
# the CPU, B=2, T=1200), so no bf16 path can match it.  Through the
# spectral term the gradient is held to 2^-3 in relative L2: bf16 in 30
# layers and the ReLU kinks after the skip sum, whose sign flips under
# bf16 noise (measured 0.027 with the plain versions on the CPU).
STEP_LOSS_REL_TOL = 2 ** -5
STEP_GRAD_REL_L2 = 2 ** -3
# benchmarks/flash_sweep.py's FastSpeech2(...) call without dtype and
# attn_impl (idim and odim are IDIM and ODIM): attention dropout 0 in both
# stacks, every other rate at its default; float32, Adam 1e-4
FS2_TRAIN_CONFIG = dict(
    adim=384, aheads=4, elayers=4, eunits=1536, dlayers=4, dunits=1536,
    transformer_enc_attn_dropout_rate=0.0,
    transformer_dec_attn_dropout_rate=0.0)
FS2_LR = 1e-4
# its 1024-frame point: 16,384 frame tokens a step (--tokens), and 64
# tokens an utterance since 1024 % 96 != 0; lengths vary below those
FS2_B, FS2_FRAMES, FS2_TOKENS = 16, 1024, 64
FS2_MIN_FRAMES, FS2_MIN_TOKENS = 700, 48
FS2_STEPS = 4
# K4's shapes: (B, T, H, dk, key lengths as a tuple or, as an int, the
# least of a seeded spread up to T, whether query rows are masked too): a
# small one, then both of the FastSpeech2 step's, the encoder's over text
# tokens and the decoder's over frames (the last gives the kernel records)
FS2_HEADS = FS2_TRAIN_CONFIG["aheads"]
FS2_DK = FS2_TRAIN_CONFIG["adim"] // FS2_HEADS
K4_SHAPES = ((2, 200, 2, 32, (200, 131), True),
             (FS2_B, FS2_TOKENS, FS2_HEADS, FS2_DK, FS2_MIN_TOKENS, False),
             (FS2_B, FS2_FRAMES, FS2_HEADS, FS2_DK, FS2_MIN_FRAMES, False))
# K4 against its plain versions, relative to each output's range.  float32:
# the kernels' 3xTF32 products keep ~22 bits and every sum runs in
# another order than cuBLAS's; the gradients sum T = 1024 terms whose
# (dp - di) factor cancels, so they lose a few more bits than the
# forward: 2^-14 (measured at most 1.8e-5 of the range, dk at the main
# shape).  bf16: the outputs are bf16 (one ulp is 2^-8 of a value) and a
# float32 difference in the order of sums now and then flips the bf16
# rounding of p or ds: 2^-7, two ulps of the largest value (measured at
# most 1.0e-3 of the range).
K4_REL_TOL = {"float32": 2 ** -14, "bfloat16": 2 ** -7}
# step 0 with flash attention against step 0 with the dense core: both run
# float32 (TF32 off), and every query row attends to the same keys (a
# key-padding mask), so they differ by float32 rounding only (the
# kernels' 3xTF32 products against cuBLAS float32), carried through eight
# layers, the Postnet's batch statistics and one backward.  The loss is
# held to 2^-14 relative and the decoder's self_attn.q weight gradients to
# 2^-10 relative L2.
FS2_LOSS_REL_TOL = 2 ** -14
FS2_GRAD_REL_L2 = 2 ** -10
# inference of the trained model, flash against dense, on valid frames:
# the same float32 rounding through eight layers and the Postnet, 2^-12
# of after_outs' range
FS2_INFER_REL_TOL = 2 ** -12
# the PWGAN recipe's run through its CLI: recipes/pwgan/conf/default.yaml
# at full widths on a seeded synthetic dump (16 train utterances: two
# batches of 8, so iteration 4 ends epoch 2; 8 dev utterances: one eval
# batch, the loader drops a partial one) of 120-200 mel frames, over the
# 85 + 2 * 2 frames a clip needs
RECIPE_CONF = "recipes/pwgan/conf/default.yaml"
RECIPE_SPLITS = {"train": 16, "dev": 8}
RECIPE_FRAMES = (120, 200)
RECIPE_DISC_START, RECIPE_INTERVAL, RECIPE_SNAPSHOTS = 2, 2, 2
RECIPE_OPTS = ["discriminator_params.vjp_mode", "recompute",
               "updater.discriminator_train_start_steps",
               str(RECIPE_DISC_START),
               "save_interval_steps", str(RECIPE_INTERVAL),
               "eval_interval_steps", str(RECIPE_INTERVAL),
               "num_snapshots", str(RECIPE_SNAPSHOTS)]
RECIPE_STEPS, RECIPE_RESUME_STEPS = 4, 6
# the training bench: save against recompute, in turns, at batch 6
BENCH_BATCH, BENCH_ITERS = 6, 10
# NVIDIA's data sheet for the H100 SXM (dense, 700 W): HBM bytes/s and
# FLOP/s by operand type (float32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# operations per row and layer of the recipe's residual stack (residual
# 64, gate 128, skip 64, aux 80): the forward's gate products (three taps
# and the aux 1x1) and skip/residual products; the backward recomputes
# the gate and runs the transposed and weight products of both
_C, _G, _S, _A = 64, 128, 64, ODIM
STACK_FWD_FLOPS = 2 * (3 * _C * _G + _A * _G + _G // 2 * (_C + _S))
STACK_BWD_FLOPS = (2 * (3 * _C * _G + _A * _G)
                   + 2 * 2 * (_G // 2 * (_C + _S) + 3 * _C * _G + _A * _G))
# per row of the discriminator's layers 1..9: eight 64 -> 64 k=3 convs and
# the 64 -> 1 output conv; its backward transposes them (dx) and forms dW;
# K3c also re-runs layers 1..8
DISC_FWD_FLOPS = 8 * 2 * 3 * _C * _C + 2 * 3 * _C
DISC_BWD_FLOPS = 2 * DISC_FWD_FLOPS
DISC_RC_FLOPS = 8 * 2 * 3 * _C * _C + DISC_BWD_FLOPS


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
    spills = [ln.strip() for ln in lib.log.splitlines() if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path}; spills: "
          + (" | ".join(spills) or "none"))


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
        limit = bound(nbytes(x, c, *weights.values(), got_x, got_s),
                      b * t * len(kw["dilations"]) * STACK_FWD_FLOPS,
                      torch.bfloat16)
        record = {"name": "pwg_residual_stack", "route": "cuda",
                  "source": "parakeet_tpu_torch/csrc/pwg_stack.cu",
                  "replaces": "parakeet_tpu/ops/pallas/pwg_stack.py:84",
                  "max_abs_err": max(e for _, e, _ in errs),
                  "ms": ms, "plain_ms": plain_ms, **limit,
                  "library_ms": None}
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


def _hold(what, got, ref, rel_tol):
    """Max abs error of got against ref, held to rel_tol of ref's range;
    returns (err, tol)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    tol = rel_tol * max(ref.abs().max().item(), 1e-6)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{what}: max abs err {err} > tol {tol}")
    return err, tol


def _hold_l2(what, got, ref, rel_l2):
    """Relative L2 error of got against ref, held to rel_l2; returns
    (max abs err, relative L2)."""
    got, ref = got.double(), ref.double()
    rel = ((got - ref).norm() / max(ref.norm().item(), 1e-12)).item()
    if not (torch.isfinite(got).all() and rel <= rel_l2):
        raise AssertionError(f"{what}: relative L2 {rel} > {rel_l2}")
    return (got - ref).abs().max().item(), rel


def _report(tag, held):
    return ", ".join(f"{n} {e:.4g} (tol {t:.4g})" for n, (e, t) in held)


def nbytes(*tensors):
    """Bytes of the tensors (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops, dtype):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``flops`` operations on ``dtype`` operands: {bound_ms,
    bound_by}."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _record(name, source, replaces, errs, ms, plain_ms, limit,
            library_ms=None):
    return {"name": name, "route": "cuda",
            "source": f"parakeet_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(e for _, (e, _) in errs), "ms": ms,
            "plain_ms": plain_ms, **limit, "library_ms": library_ms}


def phase_k2():
    """K2a and K2b against their plain versions on one group of ten
    layers of the recipe's stack; returns their records."""
    from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    gen = torch.Generator().manual_seed(SEED + 3)
    stack = ResidualStack(**{k: PWG_CONFIG[k] for k in (
        "layers", "stacks", "residual_channels", "gate_channels",
        "skip_channels")}, aux_channels=ODIM)
    seeded_init_(stack, gen)
    stack = stack.cuda()
    per = PWG_CONFIG["layers"] // PWG_CONFIG["stacks"]
    dil = stack.dilations()[:per]
    with torch.no_grad():
        wg, wso, bso = k1.pack_stack_weights(stack.fused_weights(), 64, ODIM)
    wg16 = wg[:per].to(torch.bfloat16).contiguous()
    wso16 = wso[:per].to(torch.bfloat16).contiguous()
    bso = bso[:per].contiguous()
    for b, t in (SMALL, (TRAIN_B, TRAIN_T)):
        x = torch.randn((b, t, 64), generator=gen).cuda()
        c16 = torch.randn((b, t, ODIM), generator=gen).cuda().to(
            torch.bfloat16)
        fwd = (lambda: k1.fused_group_forward_save(
            x, c16, wg16, wso16, bso, dilations=dil))
        got = fwd()
        ref = k1.group_forward_reference(x, c16, wg16, wso16, bso,
                                         dilations=dil)
        torch.cuda.synchronize()
        held_a = [(n, _hold(f"K2a {n} B={b} T={t}", g, r, K2_REL_TOL))
                  for n, g, r in zip(("x_next", "skip", "saved"), got, ref)]
        dxo = torch.randn((b, t, 64), generator=gen).cuda()
        dsk = torch.randn((b, t, 64), generator=gen).cuda()
        bwd = (lambda: k2.fused_group_backward(
            got[2], c16, wg16, wso16, dxo, dsk, dilations=dil))
        got_b = bwd()
        ref_b = k2.group_backward_reference(got[2], c16, wg16, wso16, dxo,
                                            dsk, dilations=dil)
        again = bwd()
        torch.cuda.synchronize()
        names = ("dx", "dc", "dwg", "dwso", "dbso")
        held_b = [(n, _hold(f"K2b {n} B={b} T={t}", g, r, K2_REL_TOL))
                  for n, g, r in zip(names, got_b, ref_b)]
        if not all(torch.equal(u, v) for u, v in zip(got_b, again)):
            raise AssertionError("K2b: two runs gave different gradients")
        ms_a, plain_a = cuda_ms(fwd, 10), cuda_ms(
            lambda: k1.group_forward_reference(x, c16, wg16, wso16, bso,
                                               dilations=dil), 3)
        ms_b, plain_b = cuda_ms(bwd, 10), cuda_ms(
            lambda: k2.group_backward_reference(got[2], c16, wg16, wso16,
                                                dxo, dsk, dilations=dil), 3)
        print(f"K2a B={b} T={t} (one group of {per} layers): "
              f"{_report('K2a', held_a)}; kernel {ms_a:.4f} ms, plain "
              f"{plain_a:.4f} ms (median)")
        print(f"K2b B={b} T={t}: {_report('K2b', held_b)}; bit-identical "
              f"on a second run; kernel {ms_b:.4f} ms, plain {plain_b:.4f} "
              f"ms (median)")
    row_layers = b * t * per
    limit_a = bound(nbytes(x, c16, wg16, wso16, bso, *got),
                    row_layers * STACK_FWD_FLOPS, torch.bfloat16)
    limit_b = bound(nbytes(got[2], c16, wg16, wso16, dxo, dsk, *got_b),
                    row_layers * STACK_BWD_FLOPS, torch.bfloat16)
    return (_record("pwg_residual_stack_fwd_save", "pwg_stack.cu",
                    "parakeet_tpu/ops/pallas/pwg_stack.py:93", held_a, ms_a,
                    plain_a, limit_a),
            _record("pwg_residual_stack_bwd", "pwg_stack_bwd.cu",
                    "parakeet_tpu/ops/pallas/pwg_stack_train.py:76", held_b,
                    ms_b, plain_b, limit_b))


def phase_k3():
    """K3a, K3b and K3c against their plain versions, and K3c against K3b;
    returns their records."""
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    gen = torch.Generator().manual_seed(SEED + 4)
    nl = len(k3.DISC_TAIL_DILS)
    kernels = [torch.randn((3, 64, 1 if j == nl - 1 else 64), generator=gen)
               / math.sqrt(192) for j in range(nl)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    wk, bk = k3.pack_disc_weights(kernels, biases)
    wk, bk = wk.cuda(), bk.cuda()
    slope = 0.2
    for b, t in (SMALL, (TRAIN_B, TRAIN_T)):
        h = torch.randn((b, t, 64), generator=gen).cuda()
        fwd = (lambda: k3.fused_disc_forward(h, wk, bk, slope=slope,
                                             save=True))
        got = fwd()
        ref = k3.disc_forward_reference(h, wk, bk, slope=slope)
        torch.cuda.synchronize()
        held_a = [(n, _hold(f"K3a {n} B={b} T={t}", g, r, K3_REL_TOL))
                  for n, g, r in zip(("logits", "saved"), got, ref)]
        dlog = torch.randn((b, t), generator=gen).cuda()
        bwd = (lambda: k3.fused_disc_backward(
            got[1], dlog, wk, slope=slope, need_dx=True, need_weights=True))
        got_b = bwd()
        ref_b = k3.disc_backward_reference(got[1], dlog, wk, slope=slope)
        again = bwd()
        torch.cuda.synchronize()
        held_b = [(n, _hold(f"K3b {n} B={b} T={t}", g, r, K3_REL_TOL))
                  for n, g, r in zip(("dh", "dW", "db"), got_b, ref_b)]
        if not all(torch.equal(u, v) for u, v in zip(got_b, again)):
            raise AssertionError("K3b: two runs gave different gradients")
        ms_a, plain_a = cuda_ms(fwd, 10), cuda_ms(
            lambda: k3.disc_forward_reference(h, wk, bk, slope=slope), 3)
        ms_b, plain_b = cuda_ms(bwd, 10), cuda_ms(
            lambda: k3.disc_backward_reference(got[1], dlog, wk,
                                               slope=slope), 3)
        print(f"K3a B={b} T={t} (with save): {_report('K3a', held_a)}; "
              f"kernel {ms_a:.4f} ms, plain {plain_a:.4f} ms (median)")
        print(f"K3b B={b} T={t} (dh, dW, db): {_report('K3b', held_b)}; "
              f"bit-identical on a second run; kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms (median)")
        # K3c takes h in bf16, as _DiscTailRecompute keeps it
        h16 = h.to(torch.bfloat16)
        rc = (lambda: k3.fused_disc_backward_recompute(
            h16, dlog, wk, bk, slope=slope, need_dx=True, need_weights=True))
        got_c = rc()
        ref_c = k3.disc_backward_recompute_reference(h16, dlog, wk, bk,
                                                     slope=slope)
        again = rc()
        torch.cuda.synchronize()
        held_c = [(n, _hold_l2(f"K3c {n} B={b} T={t}", g, r, K3C_REL_L2))
                  for n, g, r in zip(("dh", "dW", "db"), got_c, ref_c)]
        if not all(torch.equal(u, v) for u, v in zip(got_c, again)):
            raise AssertionError("K3c: two runs gave different gradients")
        if not torch.equal(got_c[0], got_b[0]):
            raise AssertionError(f"K3c dh B={b} T={t} is not K3b's bitwise")
        vs_b = [(n, _hold(f"K3c {n} against K3b B={b} T={t}", g, r,
                          K3C_VS_K3B_REL_TOL))
                for n, g, r in zip(("dW", "db"), got_c[1:], got_b[1:])]
        nosave = (lambda: k3.fused_disc_forward(h, wk, bk, slope=slope,
                                                save=False))
        ms_c = cuda_ms(rc, 10)
        plain_c = cuda_ms(lambda: k3.disc_backward_recompute_reference(
            h16, dlog, wk, bk, slope=slope), 3)
        ms_rc_path = cuda_ms(lambda: (nosave(), rc()), 10)
        ms_save_path = cuda_ms(lambda: (fwd(), bwd()), 10)
        print(f"K3c B={b} T={t} (dh, dW, db): max abs err, relative L2 "
              f"(tol {K3C_REL_L2}): " + ", ".join(
                  f"{n} {e:.4g}, {r:.4g}" for n, (e, r) in held_c) + "; "
              f"against K3b: dh bitwise, {_report('K3c', vs_b)}; "
              f"bit-identical on a second run; kernel {ms_c:.4f} ms, plain "
              f"{plain_c:.4f} ms; K3a without saving + K3c {ms_rc_path:.4f} "
              f"ms, K3a saving + K3b {ms_save_path:.4f} ms (median)")
    rows = b * t
    limit_a = bound(nbytes(h, wk, bk, *got), rows * DISC_FWD_FLOPS,
                    torch.bfloat16)
    limit_b = bound(nbytes(got[1], dlog, wk, *got_b),
                    rows * DISC_BWD_FLOPS, torch.bfloat16)
    limit_c = bound(nbytes(h16, dlog, wk, bk, *got_c),
                    rows * DISC_RC_FLOPS, torch.bfloat16)
    return (_record("pwg_disc_fwd", "pwg_disc.cu",
                    "parakeet_tpu/ops/pallas/pwg_disc.py:143", held_a, ms_a,
                    plain_a, limit_a),
            _record("pwg_disc_bwd", "pwg_disc.cu",
                    "parakeet_tpu/ops/pallas/pwg_disc.py:195", held_b, ms_b,
                    plain_b, limit_b),
            _record("pwg_disc_bwd_recompute", "pwg_disc.cu",
                    "parakeet_tpu/ops/pallas/pwg_disc.py:355", held_c, ms_c,
                    plain_c, limit_c))


def _train_counters():
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    return {"K1": k1.fused_residual_stack,
            "K2a": k1.fused_group_forward_save,
            "K2b": k2.fused_group_backward,
            "K3a": k3.fused_disc_forward,
            "K3b": k3.fused_disc_backward,
            "K3c": k3.fused_disc_backward_recompute}


def expected_launches(disc_on, vjp_mode="save"):
    """Kernel launches of one train step at the recipe's widths.

    Generator update: K2a once per layer; K2b gate, dw and dx per layer
    and one reduction per group.  GAN steps add the discriminator on the
    fake (K3a), its input gradient only (the discriminator's weights are
    constants there), the regeneration of the fake without a gradient
    (K1, once per layer), and the discriminator update: K3a on real and
    fake, each with the gradients of h and the weights.  With
    ``vjp_mode='save'`` K3a saves and K3b runs its reverse pass for the
    input gradient, and its reverse pass, dW pass and two reductions for
    each update; with 'recompute' K3a saves nothing and K3c runs once for
    the input gradient, and once with two reductions for each update.
    """
    layers, stacks = PWG_CONFIG["layers"], PWG_CONFIG["stacks"]
    n = {"K1": 0, "K2a": layers, "K2b": 3 * layers + stacks, "K3a": 0,
         "K3b": 0, "K3c": 0}
    if disc_on:
        n.update(K1=layers, K3a=1 + 2)
        if vjp_mode == "save":
            n["K3b"] = 1 + 2 * 4
        else:
            n["K3c"] = 1 + 2 * 3
    return n


def build_trainer(impl, out_dir):
    """A Trainer over the recipe's GAN step: 'kernels' (stack 'fused',
    discriminator 'auto', as recipes/pwgan/conf/default.yaml selects) or
    'eager' (no kernel).  Same seeded weights, batches and noise."""
    from parakeet_tpu_torch.models import (PWGDiscriminator, PWGGenerator,
                                           init_pwg_train_state,
                                           make_pwg_train_step)
    from parakeet_tpu_torch.training import (StandardUpdater, Trainer,
                                             build_optimizer, seed_everything)
    gen = torch.Generator().manual_seed(SEED + 5)
    g = PWGGenerator(aux_channels=ODIM, stack_impl=(
        "fused" if impl == "kernels" else "eager"), **PWG_CONFIG)
    d = PWGDiscriminator(impl="auto" if impl == "kernels" else "eager",
                         **DISC_CONFIG)
    seeded_init_(g, gen)
    seeded_init_(d, gen)
    g, d = g.cuda(), d.cuda()
    frames = TRAIN_T // 300 + 2 * PWG_CONFIG["aux_context_window"]
    batches = [{"wav": (0.3 * torch.randn((TRAIN_B, TRAIN_T),
                                          generator=gen)).cuda(),
                "mel": torch.randn((TRAIN_B, frames, ODIM),
                                   generator=gen).cuda()}
               for _ in range(TRAIN_STEPS)]
    state = init_pwg_train_state(
        g, d, build_optimizer(g.parameters(), "adam", GEN_LR),
        build_optimizer(d.parameters(), "adam", DISC_LR),
        seed_everything(SEED + 6, device="cuda"))
    step = make_pwg_train_step(g, d, lambda_adv=LAMBDA_ADV,
                               discriminator_train_start_steps=DISC_START,
                               **STFT_LOSS)
    log = []

    def timed_step(st, batch):
        counters = _train_counters()
        before = {k: f.launches for k, f in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {"stack": g.stack.conv_kernel.grad.clone(),
                 "first_conv": torch.cat([p.grad.flatten() for p in
                                          g.first_conv.parameters()]),
                 "upsampler": torch.cat([p.grad.flatten() for p in
                                         g.upsample_net.parameters()])}
        log.append({"ms": ms, "metrics": {k: float(v) for k, v in
                                          metrics.items()},
                    "launches": {k: f.launches - before[k]
                                 for k, f in counters.items()},
                    "grads": grads})
        return st, metrics

    updater = StandardUpdater(timed_step, state, batches)
    trainer = Trainer(updater, stop_trigger=(TRAIN_STEPS, "iteration"),
                      out=str(out_dir))
    return trainer, g, d, log, step, state, batches


def step0_spectral_grad(g, batch):
    """The stack weights' gradient of step 0's spectral-convergence loss:
    the step's noise (the state's generator, as seeded), batch and
    weights."""
    from parakeet_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
    from parakeet_tpu_torch.training import seed_everything
    rng = seed_everything(SEED + 6, device="cuda")
    wav = batch["wav"]
    noise = torch.randn((*wav.shape, 1), generator=rng, device=wav.device,
                        dtype=wav.dtype)
    sc, _ = multi_resolution_stft_loss(g(noise, batch["mel"])[..., 0], wav,
                                       **STFT_LOSS)
    sc.backward()
    grad = g.stack.conv_kernel.grad.clone()
    g.zero_grad(set_to_none=True)
    return grad


def phase_train(records, profile_dir=None):
    out = pathlib.Path("build") / "chip_smoke_train"
    trainer, g, d, log, step, state, batches = build_trainer(
        "kernels", out / "kernels")
    eager, g_e, _, log_e, _, _, batches_e = build_trainer("eager",
                                                          out / "eager")
    sc_grad = step0_spectral_grad(g, batches[0])
    sc_grad_e = step0_spectral_grad(g_e, batches_e[0])
    params0 = {f"{m}.{n}": p.detach().clone() for m, mod in
               (("generator", g), ("discriminator", d))
               for n, p in mod.named_parameters()}
    counters = _train_counters()
    for f in counters.values():
        f.launches = 0
    trainer.run()
    totals = {k: f.launches for k, f in counters.items()}
    eager.run()
    if any(f.launches != totals[k] for k, f in counters.items()):
        raise AssertionError("the eager impls launched a kernel")
    for i, (k, e) in enumerate(zip(log, log_e)):
        disc_on = i >= DISC_START
        bad = {n: v for n, v in k["metrics"].items()
               if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"step {i}: non-finite metrics {bad}")
        if k["launches"] != expected_launches(disc_on):
            raise AssertionError(f"step {i}: launches {k['launches']}, "
                                 f"expected {expected_launches(disc_on)}")
        for name, grad in k["grads"].items():
            if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
                raise AssertionError(f"step {i}: {name} gradient is zero "
                                     "or not finite")
        if (k["metrics"]["discriminator_loss"] > 0) != disc_on:
            raise AssertionError(f"step {i}: discriminator loss "
                                 f"{k['metrics']['discriminator_loss']}")
        print(f"train step {i} ({'GAN' if disc_on else 'disc off'}): "
              f"kernels {k['ms']:.2f} ms, eager {e['ms']:.2f} ms; "
              + ", ".join(f"{n} {v:.5g}" for n, v in k["metrics"].items())
              + f"; launches {k['launches']}")
    # every submodule's parameters moved (first_conv.kernel alone may not:
    # weight norm over its one input channel fixes its direction, so its
    # gradient is zero up to rounding)
    moved = {}
    for m, mod in (("generator", g), ("discriminator", d)):
        for n, p in mod.named_parameters():
            key = f"{m}.{n.split('.')[0]}"
            moved[key] = moved.get(key, False) or not torch.equal(
                params0[f"{m}.{n}"], p.detach())
    if not all(moved.values()):
        raise AssertionError(f"parameters did not move: "
                             f"{[k for k, v in moved.items() if not v]}")
    # step 0 with the kernels against step 0 on the eager impls
    k0, e0 = log[0], log_e[0]
    loss, loss_e = (k0["metrics"]["generator_loss"],
                    e0["metrics"]["generator_loss"])
    loss_err = abs(loss - loss_e)
    if not loss_err <= STEP_LOSS_REL_TOL * abs(loss_e):
        raise AssertionError(f"step 0 generator loss {loss} against eager "
                             f"{loss_e}")
    rel_l2 = ((sc_grad - sc_grad_e).norm() / sc_grad_e.norm()).item()
    if not rel_l2 <= STEP_GRAD_REL_L2:
        raise AssertionError(f"step 0 stack-weight gradient: relative L2 "
                             f"{rel_l2} > {STEP_GRAD_REL_L2}")
    gk, ge = k0["grads"]["stack"], e0["grads"]["stack"]
    rel_full = ((gk - ge).norm() / ge.norm()).item()
    print(f"train: {TRAIN_STEPS} steps at B={TRAIN_B}, T={TRAIN_T}, all "
          f"metrics finite, every submodule's parameters moved; step 0 "
          f"against eager: generator loss {loss:.6g} vs {loss_e:.6g} "
          f"(|diff| {loss_err:.3g}, tol "
          f"{STEP_LOSS_REL_TOL * abs(loss_e):.3g}), stack-weight gradient "
          f"of the spectral-convergence loss relative L2 {rel_l2:.4g} (tol "
          f"{STEP_GRAD_REL_L2}; of the whole loss {rel_full:.4g}, not "
          f"held); launches over the run {totals}")
    for name, rec in records.items():
        rec["launches"] = totals[name]
    if profile_dir is not None:
        profile_step(step, state, batches[0], pathlib.Path(profile_dir))


def profile_step(step, state, batch, out_dir, name="train_step",
                 what="GAN step"):
    """One step under torch.profiler: device time by kernel, written to
    out_dir/<name>_profile.txt."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    step(state, batch)                     # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}_profile.txt"
    path.write_text(f"wall {wall * 1e3:.2f} ms (profiled)\n{table}\n")
    print(f"profile: one {what}, profiled wall {wall * 1e3:.2f} ms -> "
          f"{path}")


def _k4_counters():
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    return {"K4a": k4.flash_attention_forward,
            "K4b": k4.flash_attention_dkv, "K4c": k4.flash_attention_dq}


def _spread_lengths(gen, b, lo, hi):
    """b lengths in [lo, hi], the first hi (so the batch spans hi)."""
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen)
    lengths[0] = hi
    return lengths


def phase_k4():
    """K4a, K4b and K4c against their plain versions in float32 and bf16;
    returns their records (the times of the last shape, float32)."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    gen = torch.Generator().manual_seed(SEED + 7)
    records = {}
    for b, t, h, dk, lengths, mask_rows in K4_SHAPES:
        if isinstance(lengths, int):
            lengths = _spread_lengths(gen, b, lengths, t)
        kv_valid = (torch.arange(t)[None] < torch.as_tensor(
            lengths)[:, None]).to(torch.int32).cuda()
        q_valid = (kv_valid.clone() if mask_rows
                   else torch.ones_like(kv_valid))
        scale = 1.0 / math.sqrt(dk)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((b, h, t, dk), generator=gen).cuda()
                           .to(dtype) for _ in range(4))
            args = (q, k, v, q_valid, kv_valid)
            o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
            ref_o, ref_lse = k4.flash_attention_reference(*args,
                                                          sm_scale=scale)
            di = (o.float() * do.float()).sum(-1)
            bwd_args = args + (do, lse, di)

            def bwd():
                return (k4.flash_attention_dq(*bwd_args, sm_scale=scale),
                        *k4.flash_attention_dkv(*bwd_args, sm_scale=scale))

            def plain_bwd():
                return (k4.flash_attention_dq_reference(*bwd_args,
                                                        sm_scale=scale),
                        *k4.flash_attention_dkv_reference(*bwd_args,
                                                          sm_scale=scale))

            got, again, ref = bwd(), bwd(), plain_bwd()
            torch.cuda.synchronize()
            tol = K4_REL_TOL[str(dtype).split(".")[1]]
            tag = f"B={b} T={t} H={h} dk={dk} {dtype}"
            held = [("o", _hold(f"K4a o {tag}", o, ref_o, tol)),
                    ("lse", _hold(f"K4a lse {tag}", lse, ref_lse, tol))]
            held += [(n, _hold(f"K4{'c' if n == 'dq' else 'b'} {n} {tag}",
                               g, r, tol))
                     for n, g, r in zip(("dq", "dk", "dv"), got, ref)]
            if not all(torch.equal(u, w) for u, w in zip(got, again)):
                raise AssertionError(f"K4b/K4c {tag}: two runs gave "
                                     "different gradients")

            def fwd_bwd(fwd, bwd_fn):
                return fwd(*args, sm_scale=scale), bwd_fn()

            ms_f = cuda_ms(lambda: k4.flash_attention_forward(
                *args, sm_scale=scale), 10)
            plain_f = cuda_ms(lambda: k4.flash_attention_reference(
                *args, sm_scale=scale), 5)
            ms_fb = cuda_ms(lambda: fwd_bwd(k4.flash_attention_forward,
                                            bwd), 10)
            plain_fb = cuda_ms(lambda: fwd_bwd(k4.flash_attention_reference,
                                               plain_bwd), 5)
            print(f"K4 {tag}: {_report('K4', held)}; bit-identical "
                  f"gradients on a second run; forward kernel {ms_f:.4f} "
                  f"ms, plain {plain_f:.4f} ms; forward + backward kernels "
                  f"{ms_fb:.4f} ms, plain {plain_fb:.4f} ms (median)")
            if dtype == torch.float32:
                times = [cuda_ms(lambda f=f: f(*bwd_args, sm_scale=scale), n)
                         for f, n in ((k4.flash_attention_dkv, 10),
                                      (k4.flash_attention_dkv_reference, 5),
                                      (k4.flash_attention_dq, 10),
                                      (k4.flash_attention_dq_reference, 5))]
                # the library's attention on the same inputs: PyTorch's
                # scaled_dot_product_attention with the same validity mask
                mask = kv_valid[:, None, None, :].bool()
                if mask_rows:
                    mask = mask & q_valid[:, None, :, None].bool()
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib_f = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                             scale=scale), 10)
                qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
                lib_fb = cuda_ms(lambda: torch.autograd.grad(
                    sdpa(qg, kg, vg, attn_mask=mask, scale=scale),
                    (qg, kg, vg), do), 10)
                print(f"K4 {tag}: K4b (dk, dv) {times[0]:.4f} ms, plain "
                      f"{times[1]:.4f} ms; K4c (dq) {times[2]:.4f} ms, plain "
                      f"{times[3]:.4f} ms; scaled_dot_product_attention "
                      f"forward {lib_f:.4f} ms, forward + backward "
                      f"{lib_fb:.4f} ms (median)")
                # score pairs this data needs: valid query rows times valid
                # keys, per item and head
                pairs = h * (q_valid.sum(1).double()
                             * kv_valid.sum(1).double()).sum().item()
                dq, dk_, dv = got
                records = {
                    "K4a": _record("flash_attention_fwd", "flash_attn.cu",
                                   "parakeet_tpu/nn/flash.py:88",
                                   held[:2], ms_f, plain_f,
                                   bound(nbytes(*args, o, lse),
                                         4 * dk * pairs, dtype), lib_f),
                    "K4b": _record("flash_attention_bwd_dkv",
                                   "flash_attn.cu",
                                   "parakeet_tpu/nn/flash.py:88",
                                   held[3:], *times[:2],
                                   bound(nbytes(*bwd_args, dk_, dv),
                                         8 * dk * pairs, dtype)),
                    "K4c": _record("flash_attention_bwd_dq",
                                   "flash_attn.cu",
                                   "parakeet_tpu/nn/flash.py:88",
                                   held[2:3], *times[2:],
                                   bound(nbytes(*bwd_args, dq),
                                         6 * dk * pairs, dtype))}
    return records


def fs2_batches(gen, b=FS2_B, n_frames=FS2_FRAMES, n_tokens=FS2_TOKENS,
                steps=FS2_STEPS):
    """``steps`` synthetic batches on the card: token ids, durations that
    sum to each utterance's frames, mel targets, pitch and energy.  Lengths
    spread down to FS2_MIN_TOKENS / FS2_TOKENS and FS2_MIN_FRAMES /
    FS2_FRAMES of the padded ones."""
    min_tokens = n_tokens * FS2_MIN_TOKENS // FS2_TOKENS
    min_frames = n_frames * FS2_MIN_FRAMES // FS2_FRAMES
    batches = []
    for _ in range(steps):
        tokens = _spread_lengths(gen, b, min_tokens, n_tokens)
        frames = _spread_lengths(gen, b, min_frames, n_frames)
        text = torch.zeros((b, n_tokens), dtype=torch.long)
        durations = torch.zeros((b, n_tokens), dtype=torch.long)
        for i, (n, f) in enumerate(zip(tokens.tolist(), frames.tolist())):
            text[i, :n] = torch.randint(1, IDIM, (n,), generator=gen)
            cuts = torch.sort(torch.randint(0, f - n + 1, (n - 1,),
                                            generator=gen)).values
            edges = torch.cat([torch.zeros(1, dtype=torch.long), cuts,
                               torch.tensor([f - n])])
            durations[i, :n] = edges.diff() + 1
        batch = {"text": text, "text_lengths": tokens,
                 "speech": torch.randn((b, n_frames, ODIM), generator=gen),
                 "speech_lengths": frames, "durations": durations,
                 "pitch": torch.randn((b, n_tokens, 1), generator=gen),
                 "energy": torch.randn((b, n_tokens, 1), generator=gen)}
        batches.append({k: v.cuda() for k, v in batch.items()})
    return batches


def build_fs2_trainer(impl, out_dir):
    """A Trainer over the port's FastSpeech2 step with attn_impl ``impl``;
    the same seeded weights, batches and dropout generator for every
    impl."""
    from parakeet_tpu_torch.models import (FastSpeech2, init_fs2_train_state,
                                           make_fs2_train_step)
    from parakeet_tpu_torch.training import (StandardUpdater, Trainer,
                                             build_optimizer, seed_everything)
    gen = torch.Generator().manual_seed(SEED + 8)
    model = FastSpeech2(IDIM, ODIM, attn_impl=impl, **FS2_TRAIN_CONFIG)
    seeded_init_(model, gen)
    model = model.cuda()
    batches = fs2_batches(gen)
    opt = build_optimizer(model.parameters(), "adam", FS2_LR)
    state = init_fs2_train_state(model, opt,
                                 seed_everything(SEED + 9, device="cuda"))
    step = make_fs2_train_step(model, opt)
    dlayers = FS2_TRAIN_CONFIG["dlayers"]
    log = []

    def timed_step(st, batch):
        counters = _k4_counters()
        before = {k: f.launches for k, f in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        q_grad = torch.cat([
            getattr(model.decoder, f"layer_{i}").self_attn.q.weight.grad
            .flatten() for i in range(dlayers)])
        log.append({"ms": ms, "metrics": {k: float(v) for k, v in
                                          metrics.items()},
                    "launches": {k: f.launches - before[k]
                                 for k, f in counters.items()},
                    "q_grad": q_grad.clone()})
        return st, metrics

    updater = StandardUpdater(timed_step, state, batches)
    trainer = Trainer(updater, stop_trigger=(FS2_STEPS, "iteration"),
                      out=str(out_dir))
    return trainer, model, log, step, state, batches


def phase_fs2_train(records, profile_dir=None):
    from parakeet_tpu_torch.models import FastSpeech2
    out = pathlib.Path("build") / "chip_smoke_fs2"
    trainer, model, log, step, state, batches = build_fs2_trainer(
        "flash", out / "flash")
    dense, model_d, log_d, _, _, _ = build_fs2_trainer("dense",
                                                       out / "dense")
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if "running" in n}
    counters = _k4_counters()
    for f in counters.values():
        f.launches = 0
    trainer.run()
    totals = {k: f.launches for k, f in counters.items()}
    dense.run()
    if any(f.launches != totals[k] for k, f in counters.items()):
        raise AssertionError("the dense run launched K4")
    per_step = FS2_TRAIN_CONFIG["elayers"] + FS2_TRAIN_CONFIG["dlayers"]
    for i, (k, d) in enumerate(zip(log, log_d)):
        for run in (k, d):
            bad = {n: v for n, v in run["metrics"].items()
                   if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"FastSpeech2 step {i}: non-finite "
                                     f"metrics {bad}")
        if k["launches"] != dict.fromkeys(counters, per_step):
            raise AssertionError(f"FastSpeech2 step {i}: K4 launches "
                                 f"{k['launches']}, expected {per_step} "
                                 "of each")
        print(f"fs2 train step {i}: flash {k['ms']:.2f} ms, dense "
              f"{d['ms']:.2f} ms; " + ", ".join(
                  f"{n} {v:.5g}" for n, v in k["metrics"].items())
              + f"; launches {k['launches']}")
    moved = {}
    for n, p in model.named_parameters():
        key = n.split(".")[0]
        moved[key] = moved.get(key, False) or not torch.equal(
            params0[n], p.detach())
    moved.update({n: not torch.equal(b, dict(model.named_buffers())[n])
                  for n, b in stats0.items()})
    if not all(moved.values()):
        raise AssertionError(f"did not move: "
                             f"{[k for k, v in moved.items() if not v]}")
    loss, loss_d = (log[0]["metrics"]["loss"], log_d[0]["metrics"]["loss"])
    loss_err = abs(loss - loss_d)
    if not loss_err <= FS2_LOSS_REL_TOL * abs(loss_d):
        raise AssertionError(f"FastSpeech2 step 0 loss {loss} (flash) "
                             f"against {loss_d} (dense)")
    gq, gq_d = log[0]["q_grad"], log_d[0]["q_grad"]
    rel_l2 = ((gq - gq_d).norm() / gq_d.norm()).item()
    if not rel_l2 <= FS2_GRAD_REL_L2:
        raise AssertionError(f"FastSpeech2 step 0 decoder q-weight "
                             f"gradient: relative L2 {rel_l2} > "
                             f"{FS2_GRAD_REL_L2}")
    print(f"fs2 train: {FS2_STEPS} steps at B={FS2_B}, {FS2_FRAMES} frames, "
          f"{FS2_TOKENS} tokens, float32, all metrics finite, every "
          f"submodule's parameters and the BatchNorm statistics moved; "
          f"step 0 flash against dense: loss {loss:.7g} vs {loss_d:.7g} "
          f"(|diff| {loss_err:.3g}, tol {FS2_LOSS_REL_TOL * abs(loss_d):.3g})"
          f", decoder q-weight gradient relative L2 {rel_l2:.4g} (tol "
          f"{FS2_GRAD_REL_L2:.4g}); K4 launches over the run {totals}")
    for name, rec in records.items():
        rec["launches"] = totals[name]
    # serving side: the trained flash model against a dense copy of it
    copy_d = FastSpeech2(IDIM, ODIM, attn_impl="dense",
                         **FS2_TRAIN_CONFIG).cuda()
    copy_d.load_state_dict(model.state_dict())
    text, lengths = batches[0]["text"], batches[0]["text_lengths"]
    before = {k: f.launches for k, f in counters.items()}
    with torch.no_grad():
        got = model.inference(text, lengths, max_frames=FS2_FRAMES)
        n_infer = {k: f.launches - before[k] for k, f in counters.items()}
        want = copy_d.inference(text, lengths, max_frames=FS2_FRAMES)
    torch.cuda.synchronize()
    if n_infer != {"K4a": per_step, "K4b": 0, "K4c": 0}:
        raise AssertionError(f"inference launched {n_infer}")
    if not torch.equal(got["frame_lengths"], want["frame_lengths"]):
        raise AssertionError("inference: frame lengths differ")
    lengths_out = want["frame_lengths"]
    valid = (torch.arange(FS2_FRAMES, device=lengths_out.device)[None]
             < lengths_out[:, None])
    err, tol = _hold("inference after_outs on valid frames",
                     got["after_outs"][valid], want["after_outs"][valid],
                     FS2_INFER_REL_TOL)
    print(f"fs2 inference (max_frames={FS2_FRAMES}, no_grad): flash "
          f"against dense after_outs on valid frames max abs err {err:.4g} "
          f"(tol {tol:.4g}); frames {lengths_out.tolist()}; "
          f"launches {n_infer}")
    if profile_dir is not None:
        profile_step(step, state, batches[0], pathlib.Path(profile_dir),
                     name="fs2_step", what="FastSpeech2 step (flash)")


def phase_recipe(record):
    """The PWGAN recipe through its CLI, ``--device cuda`` by default:
    RECIPE_STEPS steps from an empty directory, a second run to
    RECIPE_RESUME_STEPS that resumes from the newest snapshot, and a
    straight run to RECIPE_RESUME_STEPS to compare it with.  Sets K3c's
    launches in ``record``."""
    import shutil
    from parakeet_tpu_torch.recipes.pwgan import train
    from parakeet_tpu_torch.recipes.pwgan.dump import write_synthetic_dump
    out = pathlib.Path("build") / "chip_smoke_recipe"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 10,
                              splits=RECIPE_SPLITS, frames=RECIPE_FRAMES,
                              n_mels=ODIM, n_shift=300)
    counters = _train_counters()
    log = []
    make = train.make_pwg_train_step

    def timed_step_factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed_step(state, batch):
            before = {k: f.launches for k, f in counters.items()}
            i = state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            log.append({"step": i, "ms": 1e3 * (time.perf_counter() - t0),
                        "launches": {k: f.launches - before[k]
                                     for k, f in counters.items()}})
            return state, metrics
        return timed_step

    def run(name, directory, want):
        """Train to want[-1] + 1 steps in ``directory`` and check the run:
        the steps it took, each step's launches, finite train and eval
        metrics, the snapshots left and the ledger."""
        log.clear()
        last = want[-1] + 1
        trainer = train.main([
            "--config", RECIPE_CONF, "--train-metadata", str(md["train"]),
            "--dev-metadata", str(md["dev"]), "--output-dir",
            str(out / directory), "--opts", *RECIPE_OPTS,
            "train_max_steps", str(last)])
        if [s["step"] for s in log] != list(want):
            raise AssertionError(f"recipe {name} run took steps "
                                 f"{[s['step'] for s in log]}, not "
                                 f"{list(want)}")
        for s in log:
            expect = expected_launches(s["step"] >= RECIPE_DISC_START,
                                       "recompute")
            if s["launches"] != expect:
                raise AssertionError(f"recipe {name} step {s['step']}: "
                                     f"launches {s['launches']}, expected "
                                     f"{expect}")
        obs = {k: float(v) for k, v in trainer.observation.items()}
        bad = {k: v for k, v in obs.items() if not math.isfinite(v)}
        if bad or "eval/generator_loss" not in obs:
            raise AssertionError(f"recipe {name}: metrics {obs}")
        ckpt = trainer.out / "checkpoints"
        files = sorted(p.name for p in ckpt.iterdir())
        keep = [last - RECIPE_INTERVAL * i
                for i in reversed(range(RECIPE_SNAPSHOTS))]
        if files != ["records.jsonl"] + [f"snapshot_iter_{i}.npz"
                                         for i in keep]:
            raise AssertionError(f"recipe {name}: checkpoints {files}")
        ledger = [json.loads(line)["iteration"] for line in
                  (ckpt / "records.jsonl").read_text().splitlines()]
        if ledger != keep or trainer.updater.state.iteration != last:
            raise AssertionError(f"recipe {name}: ledger {ledger}, "
                                 f"{trainer.updater.state}")
        print(f"recipe {name} run: steps {list(want)} ("
              + ", ".join(f"{s['ms']:.2f}" for s in log)
              + f" ms); snapshots {files[1:]}; " + ", ".join(
                  f"{k} {v:.6g}" for k, v in obs.items()))
        return obs

    train.make_pwg_train_step = timed_step_factory
    k3a = counters["K3a"]
    for f in counters.values():
        f.launches = 0
    k3a.saves = 0
    try:
        run("first", "resumed", range(RECIPE_STEPS))
        got = run("resumed", "resumed",
                  range(RECIPE_STEPS, RECIPE_RESUME_STEPS))
        want = run("straight", "straight", range(RECIPE_RESUME_STEPS))
    finally:
        train.make_pwg_train_step = make
    totals = {k: f.launches for k, f in counters.items()}
    saves = k3a.saves
    if not (totals["K3c"] > 0 and totals["K3b"] == 0 and totals["K3a"] > 0
            and saves == 0):
        raise AssertionError(f"recipe launches {totals}, K3a saving "
                             f"{saves} times")
    # the resumed run against the straight one: the same clips, noise and
    # weights at step 4, and every kernel's sums in a fixed order, so the
    # last step's and the evaluation's metrics must agree bitwise
    if got != want:
        raise AssertionError(f"resumed run {got} against straight {want}")
    print(f"recipe: resumed at iteration {RECIPE_STEPS} and ran steps "
          f"{RECIPE_STEPS}-{RECIPE_RESUME_STEPS - 1} only; its step "
          f"{RECIPE_RESUME_STEPS - 1} and eval metrics equal the straight "
          f"run's bitwise; launches over the three runs {totals}, K3a "
          f"saving {saves} times")
    record["launches"] = totals["K3c"]


def phase_bench():
    """The training bench with the discriminator's backward saving and
    recomputing, in turns (save, recompute, recompute, save)."""
    from parakeet_tpu_torch.benchmarks import train_pwgan
    ips = {"save": [], "recompute": []}
    for mode in ("save", "recompute", "recompute", "save"):
        (rec,) = train_pwgan.main(["--disc-vjp", mode, "--batch-sizes",
                                   str(BENCH_BATCH), "--iters",
                                   str(BENCH_ITERS)])
        if not rec["value"] > 0:
            raise AssertionError(f"bench {mode}: {rec}")
        ips[mode].append(rec["value"])
    print(f"bench: pwgan_train_avg_ips at batch {BENCH_BATCH}, "
          f"{BENCH_ITERS} iterations, sequences/s: save {ips['save']}, "
          f"recompute {ips['recompute']}; recompute / save "
          f"{sum(ips['recompute']) / sum(ips['save']):.4f}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile one GAN step and one "
                             "FastSpeech2 step into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    k1 = phase_slice(phase_k1())
    k2a, k2b = phase_k2()
    k3a, k3b, k3c = phase_k3()
    phase_train({"K2a": k2a, "K2b": k2b, "K3a": k3a, "K3b": k3b},
                args.profile)
    k4 = phase_k4()
    phase_fs2_train(k4, args.profile)
    phase_recipe(k3c)
    phase_bench()
    print(json.dumps({"kernels": [k1, k2a, k2b, k3a, k3b, k3c, k4["K4a"],
                                  k4["K4b"], k4["K4c"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
