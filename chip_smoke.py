"""Smoke run of the PyTorch/CUDA port (``parakeet_tpu_torch``) on one GPU.

Run from the root of the repository on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each (the checks raise; nothing is caught):

1. the card (``nvidia-smi``: name and power limit) and the build of the
   port's CUDA kernels from ``parakeet_tpu_torch/csrc``, with each
   kernel's registers and spills by ptxas and, by
   ``cudaFuncGetAttributes``, the registers and local memory of the wide
   K4b and K4c (the thread-block clusters above head width 256), which
   must be 0;
2. kernel K1 (the fused Parallel WaveGAN residual stack) against its plain
   PyTorch version, at a small shape and at the main shape (B=1,
   T=268,800, 30 layers, the widths of recipes/pwgan/conf/default.yaml):
   max abs error against a stated tolerance, bit-identity on a second
   run, median times, and the bytes a call must move with one layer per
   launch, its rate and share of the card's 3.35 TB/s; then the same at
   residual width 128 (gate 256, skip 128: two launches a layer), at the
   small and the main shape;
3. the serving slice: a port ``TTSEngine`` on bf16 FastSpeech2 and
   PWGGenerator at the recipes' widths with weights drawn from a fixed
   ``torch.Generator`` seed answers six requests (one over the largest
   text bucket, so it is split); every wav must be finite with
   ``n_frames * 300`` samples, K1 must have launched once per layer for
   every chunk, and one request must give the same wav alone and inside a
   batch, and agree with the wav of the eager residual stack (no kernel)
   within a stated tolerance;
4. the serving path as captured programs: a graph engine (one CUDA graph a
   grid point of the engine's default grid, text 32/64/128 x batch
   1/2/4/8, captured by its warmup; its normalizers' CPU statistics moved
   to the card once) answers the six requests with the eager engine's
   wavs bit for bit; K1 launches 30 times a chunk by the replays' count
   (its own counter, which advances at capture, stays at 0); a replay's
   kernels by ``torch.profiler`` hold ``pwg_layer_kernel<64, false>`` 30
   times; it prints the capture time, the memory the graphs hold and each
   chunk's wall time, graphs against eager in turns.  Then
   ``benchmarks/e2e_rtf.py`` (``bench.py``'s program at full width, one
   CUDA graph) in bf16 and float32, 'dense' against 'flash' in turns
   (dense, flash, flash, dense; float32 once each): each graph's wav
   bitwise its eager program's, K1 x 30 and, with 'flash', K4a x 8 in a
   replay; RTF, graph and eager ms and MFU (against the bf16 peak); and
   the bf16 program against its former cast-parameter build in turns
   (``e2e_cast_yardstick``).  Then the streaming
   vocoder (one window graph, replayed per window) against one-shot
   vocoding within a stated tolerance, and ``benchmarks/longform_rtf.py``
   (6,144 frames, 'dense' and 'auto', one timed replay each);
5. kernels K2a/K2b (the residual stack's training forward and backward,
   one group of ten layers) and K3a/K3b/K3c (discriminator layers 1..9:
   forward, backward from the saved layer inputs, backward that rebuilds
   them from the layer-0 output) against their plain PyTorch versions, at
   a small shape and at the training shape (B=8, T=25,500: the PWGAN
   recipe's batch_size and batch_max_steps), at the recipe's residual
   width 64 and again at 128 (K2b's passes split over the grid's y):
   max abs errors against
   stated tolerances, outputs and gradients bit-identical from run to
   run (K2a's bytes, rate and share as K1's), K3a without saving
   bitwise K3a with saving on the logits, K3c's dh
   bitwise K3b's and its dW and db within a stated tolerance of K3b's,
   median times (K3a with and without saving apart, and K3a without
   saving + K3c against K3a saving + K3b), K3a's grid, waves and blocks
   an SM, both K3a calls with the bytes of ``k3a_bytes``, GB/s and the
   share of their bounds (the one without saving bound by FLOP), K3b's
   passes (its nine layer passes and the reduction) with the
   bytes of ``k3b_bytes``, GB/s and the share of 3.35 TB/s, and K3c's
   with those of ``k3c_bytes``;
6. the training slice: a port ``Trainer`` over ``StandardUpdater`` runs
   the PWGAN GAN step of recipes/pwgan/conf/default.yaml for four steps at
   its full widths on seeded synthetic (wav, mel) batches, with
   discriminator_train_start_steps=2, so steps 0-1 run the discriminator-
   off program and steps 2-3 the GAN program.  Every metric must be
   finite, the parameters must move, each kernel must launch the expected
   number of times per step, the residual stack, first conv and upsampler
   must get non-zero gradients, and step 0 must agree with the same step
   on the eager impls (no kernel) within stated tolerances.  It prints ms
   per step with the kernels and with the eager impls;
7. kernel K4 (flash attention: forward K4a, dK/dV pass K4b, dQ pass K4c)
   against its plain PyTorch versions in float32 and bf16, at a small
   shape (B=2, T=200, H=2, dk=32, key lengths 200 and 131, with query
   rows masked as well, jax's segment rule), at both shapes of the
   FastSpeech2 training step (B=16, H=4, dk=96: the encoder's T=64, key
   lengths 48-64, and the decoder's T=1024, key lengths 700-1024) and at
   both of the FastSpeech2 recipe's (B=16, H=2, dk=192: the encoder's
   T=128, key lengths 96-128, and the decoder's T=1024, 700-1024), and
   at the decoder's at adim 512 over 2 heads (B=16, H=2, dk=256, T=1024,
   700-1024: the DP = 256 instances) and at adim 384 and 512 over one
   head (B=16, H=1, dk=384 and 512, T=1024, 700-1024: the wide
   instances), then at dk 768 and 1024 (B=2, H=1, T=256, key lengths 256
   and 171: the widest heads K4 takes): max abs errors against stated
   tolerances (K4a against its plain version both as one softmax and
   blocked at the kernel's own key tile, ``k4a_block_k``), outputs and
   gradients bit-identical from run to run, median times of each
   kernel, of its plain version, of forward + backward, and of PyTorch's
   scaled_dot_product_attention forward, backward and both, in float32
   and bf16;
8. the FastSpeech2 training slice: two port ``Trainer``s run four steps
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
   (K4a under no_grad) must agree with a dense copy of it; then the same
   model at adim 512 over one head (dk 512, the wide instances) takes
   two float32 steps with 'flash' and two with 'dense' from the same
   weights: K4a, K4b and K4c 8 times a flash step, and each step's loss
   held to the dense one's;
9. the PWGAN recipe through its CLI (``parakeet_tpu_torch.recipes.pwgan.
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
   newest snapshots and their ledger; then the recipe at ``--opts
   generator_params.residual_channels 128 generator_params.gate_channels
   256 generator_params.skip_channels 128`` (CR128_OPTS) for 3 steps,
   the discriminator (the YAML's 'save') from step 1, each step's
   launches checked (K2a and K1 two a layer, K2b, K3a, K3b), and
   ``pwgan/synthesize.py`` on its snapshot over 2 dev lines (K1 60 times a
   line, each wav held to K1's plain version's);
10. the training bench (``parakeet_tpu_torch.benchmarks.train_pwgan``) at
   batch 6 with ``--disc-vjp save`` and ``recompute`` in turns: its
   ``pwgan_train_avg_ips`` for both;
11. the FastSpeech2 recipe through its CLI (``parakeet_tpu_torch.recipes.
   fastspeech2.train.main``, on the card) with recipes/fastspeech2/conf/
   default.yaml at full widths (adim 384 over 2 heads, dk 192; batch 64)
   with ``model.attn_impl flash`` and the attention dropout at 0, on a
   seeded synthetic dump under build/ (128 train utterances, two steps an
   epoch; 40 dev, one eval batch; 500-1000 frames, 40-120 phones): 2
   epochs with an evaluation and a snapshot each, a second run to 3 that
   must resume at iteration 4 and run steps 4-5 only, and a straight
   3-epoch run whose last train and eval metrics must equal the resumed
   run's bitwise.  Every step must launch K4a, K4b and K4c 8 times each,
   every eval batch K4a 8 times and nothing else, every metric must be
   finite; step 0 of a 'dense' run from the same weights must agree with
   flash's within the FastSpeech2 phase's tolerances; aishell3.yaml with
   ``--speaker-dict`` (the concat integration) trains an epoch of 2
   steps; default.yaml with ``--opts model.adim 512 model.aheads 2``
   (dk 256) and with ``--opts model.aheads 1`` (dk 384; flash, the
   attention dropout at 0) each trains an epoch of 2 steps over the
   Chinese frontend's phone map, and the synthesis CLI
   (``recipes.fastspeech2.synthesize_e2e``) on each snapshot, through a
   YAML of the same ``--opts``, speaks two lines vocoded by a PWG of
   seeded weights: every wav finite with the frames' samples, K1 x 30 a
   line, K4a (and no K4b or K4c) in the CLI, the AM graph bitwise its
   eager program, each mel within a stated tolerance of the same
   weights' program with 'dense'; then K4a-K4c at the dk 256 run's own
   shapes (its train batch with the most frames: the encoder's and the
   decoder's self-attention) in float32 and bf16 against their plain
   versions, timed;
12. the FastSpeech2 training bench (``parakeet_tpu_torch.benchmarks.
   train_fastspeech2``) at its defaults, 'dense' and 'flash' in turns: its
   ``fastspeech2_train_avg_ips`` for both;
13. SpeedySpeech: its recipe through its CLI (``parakeet_tpu_torch.
   recipes.speedyspeech.train.main``, on the card) with recipes/
   speedyspeech/conf/default.yaml at full widths and batch 32 on a seeded
   synthetic dump under build/ (64 train utterances, two steps an epoch;
   300-600 frames): 1 epoch, a second run to 2 that must resume at
   iteration 2 and run steps 2-3 only, and a straight 2-epoch run whose
   last train and eval metrics must equal the resumed run's bitwise, every
   metric finite, ms a step printed; then ``benchmarks/e2e_family_rtf.py``'s
   SpeedySpeech leg (96 phones -> 1,000 frames -> PWG x300, bf16) as one
   CUDA graph: its wav bitwise the eager program's, K1 x 30 in a replay,
   its RTF and ms a call; and K1 against its plain version at the
   program's shape (B=1, T=300,000);
14. Tacotron2: the same through its recipe's CLI with recipes/tacotron2/
   conf/default.yaml (full widths, batch 32, 60-100 frames: 1 epoch of 2
   steps, resumed to 2, against 2 straight); its leg of
   ``e2e_family_rtf`` (1,000 decoder steps -> PWG x256) as one CUDA graph,
   bitwise eager, K1 x 30 in a replay, and K1 at T=256,000; then the
   per-family training bench (``benchmarks/train_am.py``) at the JAX
   bench's shapes for both families, with PyTorch's defaults: each
   ``<family>_train_avg_ips`` and ms a step;
15. TransformerTTS: its recipe's CLI with recipes/transformer_tts/conf/
   default.yaml (full widths, batch 16: 1 epoch of 2 steps, resumed to 2,
   against 2 straight); its ``transformer_tts_r1`` and ``_r2`` legs of
   ``e2e_family_rtf`` at 128 frames (128 and 64 decoder steps -> PWG
   x256) as one CUDA graph each, bitwise eager, K1 x 30 in a replay, and
   K1 at T=32,768; then ``benchmarks/ar_decode.py`` (Tacotron2,
   TransformerTTS r=1 and r=2; 100 steps, each graph bitwise eager);
16. WaveFlow: its recipe's CLI with recipes/waveflow/conf/default.yaml
   (iteration-based: 2 iterations resumed to 4 against 4 straight);
   ``benchmarks/waveflow_rtf.py`` (344 frames) in float32 and bf16, each
   one CUDA graph bitwise eager, bf16 against float32 in relative L2;
   the bf16 sampler's products against float64 products at their shapes
   (float32 sums); then the training bench's TransformerTTS and WaveFlow
   legs, with PyTorch's defaults;
17. GE2E at the JAX bench's widths (64 speakers x 10 utterances x 160
   frames x 40 mels, 3 x 256 LSTM, a 256-wide embedding): one train step
   on the card against the port's CPU step from the same weights and
   batch (the loss, every gradient after the (w, b) scaling, every
   parameter after Adam, within stated float32 tolerances), the recipe's
   CLI (``parakeet_tpu_torch.recipes.ge2e.train.main``) for 4 iterations
   on a seeded tree of 640 mels with a snapshot, its ``inference.py``
   over the tree (unit norms; one embedding against the CPU's), and
   ``benchmarks/ge2e_train.py``'s ``ge2e_train_avg_ips``;
18. voice cloning through ``recipes/tacotron2_aishell3/voice_cloning.py``
   at the YAMLs' widths with random weights (GE2E's defaults, the
   aishell3 Tacotron2, WaveFlow): a seeded formant reference wav, two
   sentences of pinyin at 1,000 decoder steps, the Tacotron2 program one
   CUDA graph bitwise its eager program, WaveFlow eager, each wav finite
   with frames x 256 samples, the reference's embedding against the
   CPU's, the parts' times and the RTF; then the aishell3 recipe's CLI
   at its YAML's widths and batch 32 (60-100 frames; 1 epoch of 2 steps,
   resumed to 2, against 2 straight, bitwise);
19. text in, a waveform out through the port's CLIs at the recipe YAMLs'
   widths with random-weight snapshots it writes (the phone maps from the
   frontends' phone sets): four sentences of recipes/text_frontend/data/
   g2p_test_cases.txt through the FastSpeech2 ``synthesize_e2e`` twin
   (the AM one CUDA graph, bitwise its eager program; PWG eagerly) with
   K1 and again with K1's plain version, each wav held to the other; one
   through the SpeedySpeech twin (tones) and one English sentence through
   the TransformerTTS twin (500 decoder steps as one graph, PWG); K1 30
   times a vocoded line; the four through the serving twin (batch 8,
   ``--warmup``), its graphs' wavs bitwise its engine's eager wavs; the
   frontend's path (jieba or one word a sentence), each line's frontend,
   AM and vocoder ms, RTF and the serving twin's audio-s/s;
20. the corpus legs around training through the port's CLIs at the
   recipe YAMLs' widths with random-weight snapshots it writes: six
   seeded formant utterances (``audio/synthetic.py``) at 24 kHz with a
   durations file, and as an LJSpeech tree, through the FastSpeech2,
   PWGAN (``--cut-sil``) and Tacotron2 preprocess and normalize CLIs (host
   seconds); ``fastspeech2/synthesize.py`` on the test split,
   ``pwgan/synthesize.py`` on the dev split and
   ``pwgan/synthesize_from_wav.py`` on one wav, each with K1 and again
   with K1's plain version, each wav held to the other (K1 30 times a
   line); ``tacotron2/synthesize.py`` with WaveFlow and
   ``transformer_tts/synthesize.py`` with PWG (200 decoder steps as one
   graph each) and ``waveflow/synthesize.py`` (the sampler one graph),
   one utterance each; then the FastSpeech2 ``synthesize_e2e`` twin with
   ``--export-dir`` on phase 19's snapshots (``torch.export``: the
   exported vocoder's graph must hold K1's registered operator) and
   ``inference.py`` on two of its sentences (K1 30 times a line through
   the exported program), the exported acoustic program's mel against
   the eager program's and the exported vocoder's wav against the eager
   vocoder's on the same mel and noise, with the export's seconds and
   both vocoders' ms;
21. Paddle checkpoints through the port's converters at the recipe
   YAMLs' widths and the mixed-precision GAN step: seeded Paddle-layout
   dicts under the reference's names (a whole GAN's dump converted by
   ``tools/convert_pwg_checkpoint``, which strips the ``generator.``
   scope; the discriminator by ``convert_pwg_discriminator``;
   FastSpeech2 by ``tools/convert_fastspeech2_checkpoint``);
   ``pwgan/synthesize.py`` vocodes 100 frames with the converted
   generator (K1 30 times), its wav held against the float64 oracle of
   ``tools/golden/pwg.py`` on the card, and K1 against its plain version
   on the converted weights; the converted FastSpeech2 teacher-forced and
   as the AM graph against ``tools/golden/fastspeech2.py``; the GAN
   step's losses and gradients on a short clip in float32 and bf16
   against ``golden_pwg_gan_grads`` (and through K2a/K2b's plain
   versions); the GAN step of the converted networks at B=8, T=25,500 in
   float32 and bf16 in turns, with its launches; the discriminator's
   update at bf16, K3a/K3b against the eager loop in turns (the evidence
   behind 'auto' at bf16); the training bench in both types in turns; and
   the recipe's CLI for four steps with the YAML's bf16 ``--opts``;
22. the remaining layers and training observability: the FastSpeech2
   recipe's CLI at default.yaml's widths (dk 192) with both
   ``concat_after`` flags, ``attn_impl flash`` and ``optimizer.optim
   lamb`` for 4 steps on a seeded dump, with ``--profiler-options`` over
   iterations 1-2 (losses finite, every parameter moved, K4a-K4c 8
   launches a step and K4a 8 an eval batch; the trace through
   ``utils/timeline.py`` with at least one CUDA-stream track, and
   ``tools/op_table.py`` listing ``flash_fwd_kernel``,
   ``flash_dkv_kernel`` and ``flash_dq_kernel`` 8 times a step in the
   window; the TensorBoard event file's scalars where tensorboardX
   imports); K4a-K4c at that run's shapes, its train batch with the most
   frames (the encoder's self-attention over its phones and the
   decoder's over its frames), against their plain versions and timed;
   the same model's forward at batch 2 on the card against the
   CPU; TransformerTTS at its YAML's widths with both flags,
   teacher-forced on the card against the CPU and its KV-cached decode
   of 200 steps as one CUDA graph bitwise its eager run; and, each on the
   card against the CPU and timed with CUDA events,
   ``LightweightConvolution`` forward and backward, ``Conv1dCell``'s
   parallel call (and its 200-step loop against that call),
   ``gaussian_upsample`` and 10 ``lamb`` steps;
23. flax's mixed precision (``dtype=bfloat16``: float32 parameters and
   Adam state, bf16 products): each family's train step at its bench's
   shapes (``train_am``'s B=32 x 96 tokens x 640 frames, WaveFlow 8 x 65
   frames; ``ge2e_train``'s 64 x 10 x 160; ``train_fastspeech2``'s with
   'flash' at dk 192), float32 against bf16 in turns (float32, bf16,
   bf16, float32) after a warm step of each: ms a step, the ratio, the
   finite losses; in the bf16 FastSpeech2 step K4a-K4c's launches and,
   from ``tools/op_table.py`` over a profiled step, the names of its top
   GEMM kernels; K4a-K4c at that step's two shapes in bf16 against their
   plain versions and timed.  Phase 4's e2e program is also timed
   against its build before this one (the same weights rounded to bf16)
   in turns.
24. the main path through the entry points a user runs: the PWGAN
   twin's ``run.sh`` (``parakeet_tpu_torch/recipes/pwgan/run.sh``, stages
   0-3: preprocess, normalize, train, synthesize) and then the
   FastSpeech2 twin's (stages 0-3, synthesize_e2e with the PWGAN run's
   checkpoint), each stage a bash run with DEVICE=cuda whose ``python``
   processes report the kernels' launch counts, on a seeded formant
   corpus of 264 utterances (``recipes/corpus.py``) at the YAMLs' widths
   (``RUN_SH_CUTS``: the step counts, PWGAN's discriminator start and
   intervals, FastSpeech2's flash attention; ``RUN_SH_SWAP``: its
   preprocess in one process): K1 30 times a line in both
   synthesis stages, K2a, K2b, K3a and K3b in PWGAN's training, K4a-K4c
   in FastSpeech2's; each synthesis stage again in this process with
   K1's plain version (PWGAN's on its first RUN_SH_PLAIN_LINES dev
   lines), the twin's wavs held to it; the seconds of each
   stage with the card's name and power limit.
25. the parallel layer: one spawn of two ranks on the one card
   (``parallel/launch.py``; gloo, since NCCL refuses two ranks on one
   device, the card's tensors staged through the host where gloo needs
   it) runs, each held against a one-process run on the card of the same
   global batch: FastSpeech2 at recipes/fastspeech2/conf/default.yaml's
   widths with flash attention and dropout 0 (``PAR_*``: a seeded batch of
   16 utterances of unequal lengths, 512 frames and 64 tokens padded),
   two steps each through ``StandardUpdater`` under ``--dp 2``, ``--tp
   2`` and ``--pp 2`` (per-step losses and the parameters after step 2);
   a snapshot saved under ``--tp 2`` and loaded under ``--dp 2`` (the
   next step's loss against straight training); PWGAN ``--dp 2``, two
   GAN steps at B=8 x 25,500 (4 rows a rank, the noise in the batch, the
   discriminator from step 1, the wavs' scale rising over the rows; each
   step from the one-process run's parameters and Adam state, each
   network's gradients against its, the ranks' parameters bit for bit
   equal); FastSpeech2 synthesis with
   ``make_ring_attn_core`` at ``--sp 2`` (one utterance of 896 frames,
   its mel against the one-process run's; rank 0 vocodes with K1).  Each
   rank prints its backend, the seconds of each run and its launches of
   K1, K2a, K2b, K3a, K3b and K4a-K4c; then one rank on the card with
   NCCL (a card a rank) takes a data-parallel FastSpeech2 step and
   all-reduces its gradients over that group.

The line before the last is a JSON object with each kernel's launches on
its path (K1: serving; K2a-K3b: PWGAN training; K3c: the recipe's runs;
K4a-K4c: FastSpeech2 training at dk 96, and as ``*_dk192`` the
FastSpeech2 recipe's three flash runs, train steps and eval batches at
dk 192, as ``*_dk256`` its run at adim 512 over 2 heads and that run's
synthesis, as ``*_dk384`` its run at adim 384 over one head and that
run's synthesis, and as ``*_dk512`` phase 8's flash steps at adim 512
over one head; K4b is one launch a call at every width; K1 again as
``pwg_residual_stack_speedyspeech``, ``_tacotron2``,
``_transformer_tts_r1`` and ``_transformer_tts_r2``: the family
programs' runs, eager calls and capture, with its error and times at
their shapes; as ``pwg_residual_stack_text_to_wav`` the text-to-wav
CLIs' eager vocoder calls, at the longest line's shape; as
``pwg_residual_stack_synthesize`` phase 20's synthesis CLIs' calls, at
the FastSpeech2 CLI's longest line's shape; and as
``pwg_residual_stack_exported`` the exported vocoder's calls in
``inference.py``, at its capacity, 1,024 frames x 300; as
``pwg_residual_stack_converted`` phase 21's vocoder, at its shape on the
converted weights; K2a-K3b again as ``*_converted_float32`` and
``*_converted_bfloat16`` with the launches of phase 21's GAN steps and
phase 5's numbers, the same shapes; and K4a-K4c again as
``*_dk192_layers`` with the launches of phase 22's recipe run and the
numbers of its two shapes together, the encoder's and the decoder's
call on its largest batch; K4a-K4c again as ``*_bf16_fs2_step`` with
the launches of phase 23's bf16 FastSpeech2 step and the numbers of its
two shapes together; as ``*_run_sh`` the launches of phase 24's
twins, K1 at ``pwgan/synthesize.py``'s 1,024 frames x 300, K2a-K3b with
phase 5's numbers at the training shape the recipe runs, K4a-K4c at
the FastSpeech2 run's train batch; and K1, K2a and K2b again as
``*_cr128``: residual width 128's instances with phase 2's and 5's
numbers at the main and the training shape and the launches of phase
9's width-128 run, K1 over its steps, evaluation and synthesis), error,
times, bound
(the larger of its bytes over the H100's memory rate and its operations
over its peak for the operands' type, from this run's shapes; K4's
float32 products at the 3xTF32 rate, a third of the TF32 peak) and, where
one PyTorch call computes the same function, that call's time (for K4b
and K4c both, scaled_dot_product_attention's backward, one call that
computes dq, dk and dv); the last line is the run's result.  Without a
CUDA device it raises and prints no result.
``--profile DIR`` also writes ``torch.profiler`` tables of one GAN step
with the kernels and of one FastSpeech2 step with flash attention to DIR.
``--parent DIR`` also times K1, K2a, K3a (both), K3b and K3c of another
checkout (the parent commit, unpacked with ``git archive`` into DIR) on
the same inputs, in turns: parent, change, change, parent.
"""
import argparse
import concurrent.futures
import contextlib
import hashlib
import io
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from parakeet_tpu_torch.benchmarks.common import seeded_init_

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
LONG_T = 1843200                    # longform_rtf.py: 6,144 frames * 300
# the serving-graphs phase: the engine's default grid (text 32/64/128 x
# batch 1/2/4/8) at its default 8 frames a token, so that the memory the
# graphs hold is the default grid's
GRAPH_BATCH_BUCKETS, GRAPH_FRAMES_PER_TOKEN = (1, 2, 4, 8), 8
# the kernels as the profiler names them in a replay
K1_KERNEL, K4A_KERNEL = "pwg_layer_kernel<64, false>", "flash_fwd_kernel"
# bench.py's FastSpeech2: 4 + 4 attention layers, all on K4a with 'flash'
E2E_ATTN_LAYERS = 8
# replays a timing of the bf16 program against its cast-parameter build
E2E_YARDSTICK_REPS = 10
# streaming against one-shot: bench.py's 896 frames in windows of 256.  A
# window's upsampler products run at another row count than the whole
# utterance's, so cuBLAS may sum them in another float32 order; that now
# and then flips a bf16 rounding of c or x inside K1, carried through the
# 30 layers as in K1_REL_TOL's case: 2^-5 of the wav's range (measured
# 0.0020 at a range of 0.39, about 2^-7.6)
STREAM_FRAMES, STREAM_CHUNK = 896, 256
STREAM_REL_TOL = 2 ** -5
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
# least of a seeded spread up to T, whether query rows are masked too, the
# suffix of the kernel records the shape gives or None): a small one, then
# both of the FastSpeech2 step's, the encoder's over text tokens and the
# decoder's over frames, at flash_sweep.py's dk 96 and at the recipes' dk
# 192 (adim 384 over 2 heads): B=16, the encoder at 128 tokens (96-128
# valid) and the decoder at 1024 frames (700-1024 valid), the recipe
# phase's buckets; and the decoder's at dk 256 (adim 512 over 2 heads, the
# DP = 256 instances), dk 384 and dk 512 (adim 384 and 512 over one head,
# the wide instances); then, unrecorded, the widest heads K4 takes, dk 768
# and 1024 (the wide K4a with three and four chunks of O, K4b and K4c as
# clusters of six and eight blocks) at B=2, T=256, one item ragged
FS2_HEADS = FS2_TRAIN_CONFIG["aheads"]
FS2_DK = FS2_TRAIN_CONFIG["adim"] // FS2_HEADS
RECIPE_HEADS = FS2_CONFIG["aheads"]
RECIPE_DK = FS2_CONFIG["adim"] // RECIPE_HEADS
FS2_D256_DK = 256                   # adim 512 over 2 heads
FS2_D384_DK, FS2_D512_DK = 384, 512  # adim 384 and 512 over one head
K4_SHAPES = ((2, 200, 2, 32, (200, 131), True, None),
             (FS2_B, FS2_TOKENS, FS2_HEADS, FS2_DK, FS2_MIN_TOKENS, False,
              None),
             (FS2_B, FS2_FRAMES, FS2_HEADS, FS2_DK, FS2_MIN_FRAMES, False,
              ""),
             (16, 128, RECIPE_HEADS, RECIPE_DK, 96, False, None),
             (16, 1024, RECIPE_HEADS, RECIPE_DK, 700, False,
              f"_dk{RECIPE_DK}"),
             (16, 1024, 2, FS2_D256_DK, 700, False, f"_dk{FS2_D256_DK}"),
             (16, 1024, 1, FS2_D384_DK, 700, False, f"_dk{FS2_D384_DK}"),
             (16, 1024, 1, FS2_D512_DK, 700, False, f"_dk{FS2_D512_DK}"),
             (2, 256, 1, 768, (256, 171), False, None),
             (2, 256, 1, 1024, (256, 171), False, None))
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
# K4a's shapes inside the synthesis graphs, (T, valid keys) at batch 1 and
# FastSpeech2's 4 heads of 96: e2e_rtf's encoder over 128 tokens and
# decoder over 896 frames (357 of them valid, as its seeded durations
# give), longform_rtf's encoder over 512 tokens and decoder over 6,144
# frames.  Only the forward runs there.
K4A_GRAPH_SHAPES = ((128, 128), (896, 357), (512, 512), (6144, 6144))


def k4a_graph_tol(dtype, n_keys):
    """K4a's tolerance at a graph shape, relative to o's range.  float32:
    the kernel sums over the keys in order, tile after tile, in float32
    (its running l and o), the plain version pairwise, and recursive
    summation of n terms is off by up to n * 2^-24 relative.  At the
    training step's 1,024 keys that is K4_REL_TOL's 2^-14, at 6,144 keys
    six times it (tools/k4_accuracy_by_length.py measures the kernel's
    distance from float64 growing with n while the plain version's stays
    near 5e-7: of o's range 5.7e-6 at 128 keys, 1.4e-5 at 1,024, 6.4e-5
    at 6,144).  bf16: K4_REL_TOL, as the output's one-ulp rounding
    dominates at every length."""
    if dtype == torch.float32:
        return max(K4_REL_TOL["float32"], n_keys * 2 ** -24)
    return K4_REL_TOL["bfloat16"]
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
# the recipe at residual width 128 (gate 256, skip 128), which JAX's fused
# stack takes beside 32 and 64 and no YAML uses: its CLI with CR128_OPTS on
# phase 9's dump for RECIPE_CR128_STEPS steps, the discriminator (the
# YAML's 'save', so K3a and K3b) from step RECIPE_CR128_DISC_START, one
# evaluation and snapshot at the end; then pwgan/synthesize.py on the
# snapshot over RECIPE_CR128_LINES dev lines
CR128 = 128
CR128_OPTS = ["generator_params.residual_channels", str(CR128),
              "generator_params.gate_channels", str(2 * CR128),
              "generator_params.skip_channels", str(CR128)]
RECIPE_CR128_STEPS, RECIPE_CR128_DISC_START, RECIPE_CR128_LINES = 3, 1, 2
# the sources of K1/K2a and of K2b by residual width
K1_SOURCE = {64: "pwg_stack.cu", CR128: "pwg_stack_cr128.cu"}
K2B_SOURCE = {64: "pwg_stack_bwd.cu", CR128: "pwg_stack_bwd_cr128.cu"}
# the training bench: save against recompute, in turns, at batch 6
BENCH_BATCH, BENCH_ITERS = 6, 10
# the FastSpeech2 recipe through its CLI: recipes/fastspeech2/conf/
# default.yaml at full widths (adim 384 over 2 heads: dk 192; batch_size
# 64) with flash attention and the attention dropout at 0, as the YAML's
# comment prescribes for flash, on a seeded synthetic dump: 128 train
# utterances (two steps an epoch), 40 dev (one eval batch, the partial
# one the loader keeps), 500-1000 frames (the decoder's T bucketed to
# 512-1024) and 40-120 phones each, 8 speakers for aishell3.yaml
FS2_RECIPE_CONF = "recipes/fastspeech2/conf/default.yaml"
FS2_RECIPE_SPK_CONF = "recipes/fastspeech2/conf/aishell3.yaml"
FS2_RECIPE_SPLITS = {"train": 128, "dev": 40}
FS2_RECIPE_FRAMES, FS2_RECIPE_PHONES = (500, 1000), (40, 120)
FS2_RECIPE_SPEAKERS = 8
FS2_RECIPE_ATTN_OPTS = ["model.transformer_enc_attn_dropout_rate", "0.0",
                        "model.transformer_dec_attn_dropout_rate", "0.0"]
FS2_RECIPE_EPOCHS, FS2_RECIPE_RESUME_EPOCHS = 2, 3
FS2_RECIPE_STEPS_PER_EPOCH = 2
# the same recipe at adim 512 over 2 heads (dk 256: K4's DP = 256
# instances) and at adim 384 over one head (dk 384: the wide instances),
# default.yaml with these --opts beside FS2_RECIPE_ATTN_OPTS: one epoch
# each on the same dump (2 steps, an eval batch, a snapshot) over the
# Chinese frontend's phone map; then the synthesis CLI on each snapshot
# (a YAML of the same --opts) with a PWG of seeded weights, the first
# FS2_WIDE_LINES lines of TTW_CASES, and its acoustic model with 'dense'
# on the same weights and lines
FS2_WIDE_OPTS = {FS2_D256_DK: ["model.adim", "512", "model.aheads", "2"],
                 FS2_D384_DK: ["model.aheads", "1"]}
FS2_WIDE_LINES = 2
# dk 512 (adim 512 over one head: the wide instances at DP 512): the
# FastSpeech2 step of FS2_TRAIN_CONFIG at that width, FS2_D512_STEPS
# float32 steps with 'flash' and with 'dense' from the same weights
FS2_D512_STEPS = 2
# the FastSpeech2 training bench at its defaults (B 32, 96 tokens, 640
# frames, 4 heads), dense against flash in turns (10 iterations, cut from
# 20 to keep the script within its time limit)
FS2_BENCH_ITERS = 10
# phases 13 and 14: the SpeedySpeech and Tacotron2 recipes through their
# CLIs at their YAMLs' full widths and batch 32 on seeded synthetic dumps
# (64 train utterances: two steps an epoch; 20 and 16 dev: one eval batch
# each, the partial one the loader keeps); SpeedySpeech at Baker-like
# 300-600 frames and 40-90 phones, Tacotron2 at 120-200 frames (as many
# decoder steps a step) and 30-60 tokens, few steps, so that the phase
# fits beside the earlier ones (at 120-200 frames Tacotron2's host-bound
# steps took 1.7-2.9 s, SpeedySpeech's 1.8-2.5 s)
SS_RECIPE_CONF = "recipes/speedyspeech/conf/default.yaml"
SS_RECIPE_SPLITS = {"train": 64, "dev": 20}
SS_RECIPE_FRAMES, SS_RECIPE_PHONES = (300, 600), (40, 90)
SS_RECIPE_EPOCHS, SS_RECIPE_RESUME_EPOCHS = 1, 2
T2_RECIPE_CONF = "recipes/tacotron2/conf/default.yaml"
T2_RECIPE_SPLITS = {"train": 64, "dev": 16}
T2_RECIPE_FRAMES, T2_RECIPE_PHONES = (60, 100), (30, 60)
T2_RECIPE_EPOCHS, T2_RECIPE_RESUME_EPOCHS = 1, 2
FAMILY_STEPS_PER_EPOCH = 2
# the family programs of benchmarks/e2e_family_rtf.py, timed over one
# call after one warm call (Tacotron2's runs 1,000 decoder steps a call,
# 2.5 s eagerly in bf16), with K1's shape in each (B = 1, T = 1,000
# frames x the hop)
FAMILY_ITERS = 1
FAMILY_K1_T = {"speedyspeech": 300000, "tacotron2": 256000,
               "transformer_tts_r1": 32768, "transformer_tts_r2": 32768}
# the per-family training bench at the JAX bench's shapes (B 32, 96
# tokens, 640 frames) with PyTorch's defaults (Tacotron2's step takes
# seconds: 1 iteration after 1 warm one); the recipes' deterministic
# setting runs in every recipe phase's CLI steps, and its cost a step is
# tools/family_step_determinism.py's to measure (the bench's
# deterministic legs take ~21 s of steps)
AM_BENCH_ITERS = 1
AM_BENCH_WARMUP = 1
# phase 15: the TransformerTTS recipe at its YAML's widths and batch 16 on
# a seeded dump (32 train utterances: two steps an epoch; 8 dev: one eval
# batch) of 200-400 frames (a parallel teacher-forced decoder: as many
# steps as frames) and 40-90 tokens; its two programs at 128 frames (128
# and 64 decoder steps; an eager r=1 call at 1,000 took 10-16 s in bf16,
# at 500 the two captures took 30 s, and at 250 the phase 80-90 s, so
# cut to keep the script within its time limit) timed over 1 call
# without a warm one
TT_RECIPE_CONF = "recipes/transformer_tts/conf/default.yaml"
TT_RECIPE_SPLITS = {"train": 32, "dev": 8}
TT_RECIPE_FRAMES, TT_RECIPE_PHONES = (200, 400), (40, 90)
TT_RECIPE_EPOCHS, TT_RECIPE_RESUME_EPOCHS = 1, 2
TT_FAMILY_ITERS = 1
TT_FAMILY_FRAMES = 128
# ar_decode's loops at 100 steps, timed over 1 call without a warm one
# (at its default 500 the three captures alone took 33 s, at 200 12.9 s)
AR_DECODE_ITERS = 1
AR_DECODE_STEPS = 100
# phase 16: the WaveFlow recipe at its YAML's widths and batch on a seeded
# dump of 16 train utterances (two iterations an epoch) and 8 dev (one
# eval batch) of 80-160 frames (longer than the 65-frame clips), with an
# evaluation and a snapshot every 2 iterations; waveflow_rtf over 3
# chained calls; the bf16 sampler's wav against the float32 one's within
# a relative L2 of 2^-5 (the activations' bf16 rounding, 2^-9 a value,
# through 8 x 15 rows of small steps, with the recipe's random weights)
WF_RECIPE_CONF = "recipes/waveflow/conf/default.yaml"
WF_RECIPE_SPLITS = {"train": 16, "dev": 8}
WF_RECIPE_FRAMES = (80, 160)
WF_RECIPE_ITERS, WF_RECIPE_RESUME_ITERS = 2, 4
WF_RECIPE_OPTS = ["valid_interval", "2", "save_interval", "2"]
WAVEFLOW_ITERS = 3
WAVEFLOW_BF16_REL_L2 = 2 ** -5
# the bf16 sampler's products (``mm_f32``) at its shapes against float64
# products of the same bf16 values: float32 sums are ~1e-6 of the range
# off, a bf16 result up to 2^-9
WAVEFLOW_ACCUM_REL = 1e-4
# phase 17: GE2E at the JAX bench's widths (64 speakers x 10 utterances x
# 160 frames x 40 mels, 3 x 256 LSTM, a 256-wide embedding, Adam 1e-4):
# one step on the card against the port's CPU step on the same batch and
# weights (losses within 1e-5 relative; each gradient within 1e-4
# relative L2 of its leaf's; after Adam, an element whose gradient is at
# least 1e-3 of its leaf's largest within 1e-2 lr of the CPU's; the others,
# and b, whose gradient is rounding noise since b adds to every logit, are
# not held: Adam's first step moves each by about lr times the sign of its
# gradient, whatever its size), then the recipe's CLI for 4 iterations on a seeded tree of 64
# speakers x 10 utterances of 160-300 frames with a snapshot at 4, its
# inference over the tree, and the bench over 5 iterations
GE2E_SPEAKERS, GE2E_UTTS, GE2E_FRAMES, GE2E_MELS = 64, 10, 160, 40
GE2E_LR = 1e-4
GE2E_TREE_FRAMES = (160, 300)
GE2E_ITERS = 4
GE2E_BENCH_ITERS = 5
GE2E_LOSS_RTOL, GE2E_GRAD_REL_L2, GE2E_SURE, GE2E_MOVE_TOL = (
    1e-5, 1e-4, 1e-3, 1e-2)
# phase 18: voice cloning at the YAMLs' widths (GE2E's defaults,
# recipes/tacotron2_aishell3/conf/default.yaml's Tacotron2,
# recipes/waveflow/conf/default.yaml's WaveFlow), random weights: two
# sentences of pinyin through the CLI at its defaults (text padded to 128,
# 1,000 decoder steps), then the aishell3 recipe at its YAML's widths and
# batch 32 on a seeded dump (64 train utterances: two steps an epoch; 16
# dev) of 60-100 frames and 30-60 phones (at 120-200 its host-bound steps
# took 2.0-2.9 s): 1 epoch resumed to 2 against 2
VC_RECIPE_CONF = "recipes/tacotron2_aishell3/conf/default.yaml"
VC_SENTENCES = (
    "vc_0001 jin1 tian1 tian1 qi4 hen3 hao3 wo3 men5 yi4 qi3 qu4 gong1 "
    "yuan2 san4 bu4 ba5",
    "vc_0002 zhe4 shi4 yi2 ge4 yong4 lai2 ce4 shi4 sheng1 yin1 ke4 long2 "
    "de5 ju4 zi5 qing3 ren4 zhen1 ting1")
# the reference speaker: a formant utterance of ~1.9 s at 16 kHz (two
# partial windows of 160 frames)
VC_REF_PHONES = [("sil", 0.1), ("a", 0.3), ("i", 0.25), ("s", 0.15),
                 ("u", 0.3), ("e", 0.25), ("sh", 0.15), ("o", 0.3),
                 ("sil", 0.1)]
VC_RECIPE_SPLITS = {"train": 64, "dev": 16}
VC_RECIPE_FRAMES, VC_RECIPE_PHONES = (60, 100), (30, 60)
VC_RECIPE_EPOCHS, VC_RECIPE_RESUME_EPOCHS = 1, 2
# phase 19: text in, a waveform out, through the port's CLIs at the recipe
# YAMLs' widths with random weights written as snapshots: the first four
# sentences of the Chinese G2P cases through the FastSpeech2 CLI (with K1
# and with its plain version) and the serving twin (batch 8, warmed up),
# one of them through the SpeedySpeech CLI (tones), one English sentence
# through the TransformerTTS CLI (500 decoder steps, its default) with
# PWG.  The duration heads give ~5 frames a phone (log 5 +- 0.25, as the
# serving slice's engine) and the CLIs floor them at TTW_MIN_DURATION
TTW_CASES = "recipes/text_frontend/data/g2p_test_cases.txt"
TTW_LINES = 4
TTW_EN_SENTENCE = "tt_0001 The quick brown fox jumped over the lazy dog."
TTW_MIN_DURATION = 2
TTW_SERVE_BATCH = 8
# phase 20: the corpus legs around training, at the recipe YAMLs' widths
# with random-weight snapshots: six formant utterances at 24 kHz (a
# durations file of two speakers, and the same wavs as an LJSpeech tree)
# through the preprocess and normalize CLIs (one dev and two test
# utterances; the LJSpeech tree one and one), then synthesis from the
# dumps: FastSpeech2 and PWG on their test and dev splits and copy
# synthesis of one wav, each with K1 and with its plain version;
# Tacotron2 -> WaveFlow, WaveFlow alone and TransformerTTS -> PWG on one
# utterance each, the decodes over CORPUS_STEPS steps as one graph each
# (their stop logits' bias at CORPUS_STOP_BIAS: they decode every step),
# WaveFlow's sampler one graph at CORPUS_WF_FRAMES (a cut of its 1,024);
# then FastSpeech2's e2e twin with --export-dir on phase 19's snapshots
# and inference.py on CORPUS_EXPORT_LINES of its sentences
CORPUS_PHONES = [
    [("sil", 0.10), ("a", 0.20), ("s", 0.10), ("i", 0.20), ("sil", 0.10)],
    [("sil", 0.08), ("o", 0.25), ("sh", 0.12), ("u", 0.18), ("sil", 0.10)],
    [("sil", 0.10), ("e", 0.22), ("f", 0.10), ("a", 0.24), ("sil", 0.08)],
    [("sil", 0.06), ("i", 0.30), ("h", 0.08), ("o", 0.20), ("sil", 0.10)],
    [("sil", 0.10), ("u", 0.18), ("s", 0.14), ("e", 0.26), ("sil", 0.06)],
    [("sil", 0.08), ("a", 0.16), ("sh", 0.10), ("i", 0.28), ("sil", 0.10)]]
CORPUS_LJ_TEXT = ["Printing, in the only sense", "with which we are at",
                  "present concerned, differs", "from most if not from all",
                  "the arts and crafts", "represented in the Exhibition."]
CORPUS_STEPS = 200
CORPUS_STOP_BIAS = -10.0
CORPUS_WF_FRAMES = 256
CORPUS_EXPORT_LINES = 2
# phase 21: Paddle-layout state dicts drawn from a seed at the recipe
# YAMLs' widths, converted by the port's CLIs.  The converted generator
# vocodes CONV_FRAMES mel frames through pwgan/synthesize.py (K1), held
# against the float64 oracle of tools/golden/pwg.py on the card; the
# converted FastSpeech2 (default.yaml's widths; the CLIs read 5 pitch
# predictor layers where the YAML names none) runs teacher-forced on
# CONV_FS2_LENGTHS phones and as the AM graph on the first, held against
# tools/golden/fastspeech2.py's float64 forward; the GAN step of the
# converted networks at TRAIN_B x TRAIN_T in float32 and mixed bf16, timed
# in turns, and its gradients on a clip of CONV_CLIP_FRAMES frames against
# golden_pwg_gan_grads; the discriminator's K3a/K3b against its eager
# loop at bf16, in turns; the training bench in both types in turns and
# the recipe's CLI with the YAML's bf16 --opts for CONV_RECIPE_STEPS steps
CONV_FRAMES = 100
CONV_FS2_LENGTHS = (96, 70)
CONV_FS2_MAX_FRAMES = 1024
CONV_FS2_PITCH_LAYERS = 5
CONV_CLIP_FRAMES = 24
CONV_STEP_ITERS = 3
CONV_DISC_REPS = 5
CONV_BENCH_ITERS = 10
CONV_RECIPE_STEPS = 4
CONV_BF16_OPTS = ["generator_params.dtype", "bfloat16",
                  "discriminator_params.dtype", "bfloat16"]
# the converted vocoder's wav (K1: bf16 operands, float32 sums) against
# the float64 oracle: K1 rounds x to bf16 at group ends and h inside every
# layer, about 1% of the wav's range, as REFERENCE_REL_TOL
CONV_WAV_REL_TOL = REFERENCE_REL_TOL
# the converted FastSpeech2 in float32 (TF32 off) against float64: sums
# of 384-1,536 products over eight layers and the Postnet; 2^-10 of each
# output's range (the CPU tests hold the tiny fixtures to 1e-3 absolute),
# teacher-forced and free-running at the utterance's own length.  The AM
# graph decodes to its 1,024-frame capacity, as the JAX package's static
# programs do: the decoder's feed-forward convolutions read the frames
# past the utterance at its last frames (the reference decodes exactly
# the utterance), and the next layers' self-attention carries that to
# every frame, diluted by the softmax (9.6e-4 of the range at 354 frames
# measured on one H100); its frames outside the convolutions' reach are held
# to 2^-8
CONV_FS2_REL_TOL = 2 ** -10
CONV_FS2_GRAPH_REL_TOL = 2 ** -8
# the GAN step's losses against float64, relative; the discriminator's
# gradients and the generator's through the spectral-convergence and
# adversarial terms in relative L2 (measured on the CPU at these widths
# with the kernels' plain versions: 2.3e-3 and 4.5e-3 for the
# discriminator, 2.2e-3 and 5.7e-3 for the generator, float32 and bf16).
# On the card the adversarial term's input gradient comes back through
# the discriminator's kernels (K3a/K3b: bf16 operands), which the CPU's
# eager float32 discriminator does not round: 1.6% at float32 as
# measured on one H100, so the generator's part is held to 2^-4.  The generator's whole
# gradient is dominated by the log-magnitude term's near-silent bins
# (STEP_GRAD_REL_L2's reason): any bf16 operand moves it by 11-19% in
# relative L2 (the CPU measurement, 8.5e-5 with no bf16 product at all;
# 19.4% on the card), so it is held to 2^-2, which a wrong layout still
# fails by far
CONV_LOSS_REL_TOL = 2 ** -9
CONV_GRAD_REL_L2 = 2 ** -6
CONV_GEN_GRAD_REL_L2 = 2 ** -4
CONV_FULL_GRAD_REL_L2 = 2 ** -2
# phase 22, the remaining layers and training observability: the
# FastSpeech2 recipe's CLI at default.yaml's widths (dk 192) with both
# concat_after flags, flash attention and lamb, the attention dropout at 0
# (as for flash in phase 11), on a seeded dump of 64 train utterances
# (four steps of 16 an epoch, so that the evaluation after the fourth
# falls outside the profiler's window of iterations 1-2) and 16 dev, of
# 300-600 frames and 40-120 phones
LAYERS_SPLITS = {"train": 64, "dev": 16}
LAYERS_FRAMES, LAYERS_PHONES = (300, 600), (40, 120)
LAYERS_BATCH, LAYERS_WINDOW = 16, (1, 3)
LAYERS_OPTS = ["model.encoder_concat_after", "true",
               "model.decoder_concat_after", "true", "model.attn_impl",
               "flash", "optimizer.optim", "lamb", *FS2_RECIPE_ATTN_OPTS]
# the card's float32 (TF32 off; K4's float32 products as 3xTF32) against
# the CPU's, both from the same weights and inputs: a few hundred to 1,536
# products a sum through 4 + 4 (FastSpeech2) or 6 + 6 (TransformerTTS)
# layers and the Postnet, in other orders; 2^-12 of each output's range
# (float32 rounding of such sums is ~1e-6 of it); the layers' gradients,
# sums over B x T = 16,384 rows, 2^-10
LAYERS_REL_TOL = 2 ** -12
LAYERS_GRAD_REL_TOL = 2 ** -10
# TransformerTTS at its YAML's widths (adim 512 over 8 heads: dk 64) with
# both flags: teacher-forced at batch 2 (text 96 and 70 tokens, 200 and
# 150 frames) and the KV-cached decode of 200 steps as one CUDA graph
LAYERS_TTS_TEXT, LAYERS_TTS_FRAMES = (96, 70), (200, 150)
LAYERS_TTS_STEPS = 200
# the single layers: LightweightConvolution (wshare 4, n_feat 384, k 31)
# at B=16, T=1024; Conv1dCell (384 -> 384, k 3, dilation 2) over 200 steps
# at B=16; gaussian_upsample at B=16, L=128, T=1,024, D=384; lamb over 10
# steps of seeded gradients on FastSpeech2-sized tensors; medians of 10
LIGHTCONV_B, LIGHTCONV_T, LIGHTCONV_C, LIGHTCONV_K = 16, 1024, 384, 31
CELL_B, CELL_C, CELL_DILATION = 16, 384, 2
GAUSS_B, GAUSS_L, GAUSS_T, GAUSS_D = 16, 128, 1024, 384
# phase 23: the benches' shapes (train_am's and train_fastspeech2's batch,
# tokens and frames; ge2e_train's speakers, utterances, frames, mels), the
# families in the order they run, the GEMM kernels' names as the profiler
# gives them (cuBLAS's nvjet and sm90/sm80 kernels, CUTLASS's) and how
# many of the longest are printed
MP_AM_SHAPE = (32, 96, 640)
MP_GE2E = (64, 10, 160, 40)
MP_FAMILIES = ("fastspeech2", "speedyspeech", "tacotron2",
               "transformer_tts", "waveflow", "ge2e")
MP_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|sm\d\d_", re.IGNORECASE)
MP_TOP_GEMMS = 3
LAMB_SHAPES = [(1536, 384), (384, 1536), (384, 384), (384,), (80, 384),
               (1536,)]
LAMB_STEPS, LAYERS_REPS = 10, 10
# phase 24: the run.sh twins of PWGAN and FastSpeech2 (stages 0-3 each)
# as subprocesses with DEVICE=cuda on a seeded formant corpus of
# RUN_SH_UTTS utterances of RUN_SH_SYLLABLES syllables (1.2-2 s: longer
# than PWGAN's 25,500-sample clip and its context): the 200 dev and test
# utterances the scripts' preprocess keeps and one FastSpeech2 batch of
# 64 to train on.  Each twin's CONF is its recipe YAML with only the keys
# of RUN_SH_CUTS changed: the step counts, PWGAN's discriminator start (so
# that K3 launches within the steps), PWGAN's eval and snapshot
# intervals (keys its YAML leaves to the CLI's defaults, 1,000 and
# 10,000), and FastSpeech2's flash attention with the attention dropout
# at 0, as the YAML's comment prescribes for it (so that K4 launches)
RUN_SH_UTTS = 264
# the PWGAN twin's synthesis stage vocodes the 100 dev lines (K1 30 times
# each); the first RUN_SH_PLAIN_LINES are vocoded again in this process
# with K1's plain version and held to the twin's (all 100 take ~10 s)
RUN_SH_PLAIN_LINES = 10
RUN_SH_SYLLABLES = (7, 9)
# the twins' flags that the ``python`` on their PATH replaces, as the
# CPU tests' interpreter does: the FastSpeech2 twin's preprocess runs in
# one process instead of its 8 spawned workers, each of which imports
# torch before its first utterance (most of that stage's ~60 s for 264
# utterances of ~0.05 s each)
RUN_SH_SWAP = {"--num-cpu": "1"}
RUN_SH_CUTS = {
    "pwgan": {"train_max_steps": 4,
              "updater.discriminator_train_start_steps": 2,
              "eval_interval_steps": 4, "save_interval_steps": 4},
    "fastspeech2": {"max_epoch": 2, "model.attn_impl": "flash",
                    "model.transformer_enc_attn_dropout_rate": 0.0,
                    "model.transformer_dec_attn_dropout_rate": 0.0}}
# NVIDIA's data sheet for the H100 SXM (dense, 700 W): HBM bytes/s and
# FLOP/s by operand type (float32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K4 runs its float32 products on the tensor cores as 3xTF32, three TF32
# products (495 TFLOP/s) for each: 165 TFLOP/s of float32 products
K4_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}


def stack_fwd_flops(cr, ca=ODIM):
    """Operations per row and layer of a residual stack of residual width
    ``cr`` (gate 2cr, skip cr: the recipe's 64, 128, 64) and ``ca`` aux
    channels: the gate products (three taps and the aux 1x1) and the
    skip/residual products."""
    g = 2 * cr
    return 2 * (3 * cr * g + ca * g + g // 2 * (cr + cr))


def stack_bwd_flops(cr, ca=ODIM):
    """The backward's: it recomputes the gate and runs the transposed and
    weight products of both."""
    g = 2 * cr
    return (2 * (3 * cr * g + ca * g)
            + 2 * 2 * (g // 2 * (cr + cr) + 3 * cr * g + ca * g))


# at the recipe's widths (residual 64, aux 80)
STACK_FWD_FLOPS = stack_fwd_flops(64)
STACK_BWD_FLOPS = stack_bwd_flops(64)
# per row of the discriminator's layers 1..9 (64 channels): eight 64 -> 64
# k=3 convs and the 64 -> 1 output conv; its backward transposes them (dx)
# and forms dW; K3c also re-runs layers 1..8
_C = DISC_CONFIG["conv_channels"]
DISC_FWD_FLOPS = 8 * 2 * 3 * _C * _C + 2 * 3 * _C
DISC_BWD_FLOPS = 2 * DISC_FWD_FLOPS
DISC_RC_FLOPS = 8 * 2 * 3 * _C * _C + DISC_BWD_FLOPS


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


def cuda_ms_per_call(fn, reps, calls=10):
    """Median milliseconds a call of ``fn()`` over ``reps`` runs of
    ``calls`` calls back to back (CUDA events): the host enqueues ahead of
    the card, so the time is the card's, not a short call's host
    overhead."""
    def run():
        for _ in range(calls):
            fn()
    return cuda_ms(run, reps) / calls


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from parakeet_tpu_torch.ops.kernels._build import load_library
    t0 = time.perf_counter()
    lib = load_library()
    entries = ptxas_entries(lib.log)
    spills = [f"{name} {regs} registers, {st}/{ld} bytes spilled/loaded"
              for name, regs, st, ld in entries if st or ld]
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path}; spills: "
          + (" | ".join(spills) or "none"))
    for tag, prefix in (("K1/K2a", ("pwg_layer_", "pwg_gate_", "pwg_out_")),
                        ("K2b", "k2b_"),
                        ("K3", "disc_"), ("K4", "flash_")):
        print(f"ptxas, {tag}: " + ", ".join(
            f"{name} {regs} ({st + ld})" for name, regs, st, ld in entries
            if name.startswith(prefix)) + " (registers a thread, spill "
            "bytes)")
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    attrs = [(n, dt, *k4.k4_wide_bwd_attrs(n, dt)) for n in ("K4b", "K4c")
             for dt in (torch.float32, torch.bfloat16)]
    print("cudaFuncGetAttributes, K4b and K4c above dk 256 (clusters): "
          + ", ".join(f"{n} {dt} {regs} registers, {local} bytes local"
                      for n, dt, regs, local in attrs))
    spilled = [(n, dt, local) for n, dt, _, local in attrs if local]
    if spilled:
        raise AssertionError(f"the wide K4b/K4c use local memory: {spilled}")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
# a kernel of csrc/ in the anonymous namespace of its file: its name, then
# its template arguments, if any (K4's element type and DP, K2b's residual
# width, K1/K2a's residual width and SAVE)
_KERNEL_NAME = re.compile(r"_cu_[0-9a-f]+\d+([A-Za-z]\w*?)(I|E)")
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(f)|13__nv_bfloat16")


def kernel_name(mangled):
    """A csrc/ kernel's name as ``flash_dq_kernel<float, 96>``,
    ``k2b_dw_kernel<64>`` or ``pwg_layer_kernel<64, false>``, from its
    mangled name (itself where it is not one of those)."""
    k = _KERNEL_NAME.search(mangled)
    if k is None:
        return mangled
    if k.group(2) == "E":
        return k.group(1)
    args, pos = [], k.end()
    while (m := _TEMPLATE_ARG.match(mangled, pos)) is not None:
        args.append(m.group(1) or {"0": "false", "1": "true"}.get(
            m.group(2)) or ("float" if m.group(3) else "bf16"))
        pos = m.end()
    return f"{k.group(1)}<{', '.join(args)}>"


def ptxas_entries(log):
    """(kernel, registers, spill bytes stored, loaded) of each entry
    function in an ``nvcc -Xptxas -v`` log, named by ``kernel_name``."""
    entries, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if m := _PTXAS_ENTRY.search(ln):
            name = kernel_name(m.group(1))
            spill = (0, 0)
        elif m := _PTXAS_SPILL.search(ln):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _PTXAS_REGS.search(ln)) and name is not None:
            entries.append((name, int(m.group(1)), *spill))
            name = None
    return entries


def layer_traffic(k1, b, t, ms, layers, stacks, save, cr=64):
    """The bytes K1 (or K2a, ``save``) at residual width ``cr`` must move
    with one layer per launch (``k1_layer_bytes``; two launches a layer at
    cr 128), the rate of a call that took ``ms`` and its share of the
    card's 3.35 TB/s."""
    moved = k1.k1_layer_bytes(b, t, cr, ODIM, layers, stacks, save)
    floor_ms = 1e3 * moved / PEAK_BYTES_PER_S
    return (f"{moved / 1e9:.4f} GB with one layer per launch "
            f"(k1_layer_bytes), {moved / ms / 1e6:.0f} GB/s, "
            f"{100 * floor_ms / ms:.1f}% of 3.35 TB/s (floor "
            f"{floor_ms:.4f} ms)")


def load_parent(root):
    """``parakeet_tpu_torch.ops.kernels.pwg_stack`` of the checkout at
    ``root`` (``--parent``), imported as the package ``parent_ptt``; it
    builds its own kernels under ``root``'s build/."""
    import importlib
    import importlib.util
    import sys
    pkg = pathlib.Path(root).resolve() / "parakeet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_ptt", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_ptt"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_ptt.ops.kernels.pwg_stack")


def parent_module(name):
    """The parent checkout's ``parakeet_tpu_torch.ops.kernels.<name>``,
    after ``load_parent``."""
    import importlib
    return importlib.import_module(f"parent_ptt.ops.kernels.{name}")


def in_turns(ours, theirs, reps, timer=cuda_ms):
    """Median ms of ``theirs`` (the parent's kernel) and ``ours`` by
    ``timer``, timed parent, change, change, parent: ([parent, parent],
    [change, change])."""
    a, b, c, d = (timer(f, reps) for f in (theirs, ours, ours, theirs))
    return [a, d], [b, c]


def stack_widths(cr):
    """The recipe's residual stack's arguments at residual width ``cr``
    (gate 2cr, skip cr; the YAML's 64 or the 128 of CR128_OPTS)."""
    return dict(layers=PWG_CONFIG["layers"], stacks=PWG_CONFIG["stacks"],
                residual_channels=cr, gate_channels=2 * cr,
                skip_channels=cr, aux_channels=ODIM)


def k1_stack(gen, cr=64):
    """The recipe's residual stack (at residual width ``cr``) on the card
    with seeded weights: (stack, its fused weights, the stack arguments,
    layers)."""
    from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
    stack = ResidualStack(**stack_widths(cr))
    seeded_init_(stack, gen)
    stack = stack.cuda()
    kw = dict(dilations=stack.dilations(), stacks=stack.stacks)
    return stack, stack.fused_weights(), kw, len(kw["dilations"])


@torch.no_grad()     # the plain version at LONG_T would save 30 layers
def k1_check(gen, b, t, parent=None, name="pwg_residual_stack", stack=None,
             cr=64):
    """K1 against its plain version at (B, T) on seeded inputs (and the
    weights of ``stack``, a ResidualStack on the card, when given; else
    the recipe's stack at residual width ``cr``): max abs error against
    the tolerance, bit-identity on a second run, median times; with
    ``parent`` (the parent checkout's pwg_stack module), also the parent's
    kernel, in turns.  Returns the kernel record."""
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    if stack is None:
        stack, weights, kw, layers = k1_stack(gen, cr)
    else:
        kw = dict(dilations=stack.dilations(), stacks=stack.stacks)
        weights, layers = stack.fused_weights(), stack.layers
    cr = stack.residual_channels
    x = torch.randn((b, t, cr), generator=gen).cuda()
    c = torch.randn((b, t, ODIM), generator=gen).cuda()
    got_x, got_s = k1.fused_residual_stack(x, c, weights, **kw)
    ref_x, ref_s = k1.fused_residual_stack_reference(x, c, weights, **kw)
    again = k1.fused_residual_stack(x, c, weights, **kw)
    torch.cuda.synchronize()
    errs = []
    for part, got, ref in (("x", got_x, ref_x), ("skip", got_s, ref_s)):
        err = (got.float() - ref.float()).abs().max().item()
        tol = K1_REL_TOL * max(1.0, ref.float().abs().max().item())
        if not err <= tol:
            raise AssertionError(f"K1 {part} at B={b} T={t}: max abs err "
                                 f"{err} > tol {tol}")
        errs.append((part, err, tol))
    if not (torch.equal(again[0], got_x) and torch.equal(again[1], got_s)):
        raise AssertionError("K1: two runs gave different results")
    del ref_x, ref_s, again
    run = (lambda: k1.fused_residual_stack(x, c, weights, **kw))
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(
        lambda: k1.fused_residual_stack_reference(x, c, weights, **kw), 5)
    print(f"K1 B={b} T={t} ({layers} layers, residual {cr}): " + ", ".join(
        f"{n} max_abs_err {e:.6g} (tol {tl:.6g})" for n, e, tl in errs)
        + f"; bit-identical on a second run; kernel {ms:.4f} ms "
        f"({ms / layers:.4f} a layer), plain {plain_ms:.4f} ms (median); "
        + layer_traffic(k1, b, t, ms, layers, stack.stacks, False, cr))
    if parent is not None:
        theirs, ours = in_turns(run, lambda: parent.fused_residual_stack(
            x, c, weights, **kw), 20)
        print(f"K1 B={b} T={t}, parent, change, change, parent: "
              f"{theirs[0]:.4f}, {ours[0]:.4f}, {ours[1]:.4f}, "
              f"{theirs[1]:.4f} ms; parent "
              + layer_traffic(k1, b, t, statistics.mean(theirs), layers,
                              stack.stacks, False))
    limit = bound(nbytes(x, c, *weights.values(), got_x, got_s),
                  b * t * layers * stack_fwd_flops(cr), torch.bfloat16)
    return {"name": name, "route": "cuda",
            "source": f"parakeet_tpu_torch/csrc/{K1_SOURCE[cr]}",
            "replaces": "parakeet_tpu/ops/pallas/pwg_stack.py:84",
            "launches": 0, "max_abs_err": max(e for _, e, _ in errs),
            "ms": ms, "plain_ms": plain_ms, **limit, "library_ms": None}


def phase_k1(parent=None):
    """K1 against its plain version at a small shape, at longform's and at
    the main shape, then at residual width 128 at the small and the main
    shape; returns the main shape's kernel records (64, 128).  With
    ``parent`` (the parent checkout's pwg_stack module), also times the
    parent's kernel at the main shape, in turns."""
    gen = torch.Generator().manual_seed(SEED + 1)
    for b, t in (SMALL, (1, LONG_T)):
        k1_check(gen, b, t)
    rec = k1_check(gen, 1, MAIN_T, parent)
    k1_check(gen, *SMALL, cr=CR128)
    return rec, k1_check(gen, 1, MAIN_T, name="pwg_residual_stack_cr128",
                         cr=CR128)


def build_engine(graphs, text_buckets=TEXT_BUCKETS,
                 batch_buckets=BATCH_BUCKETS,
                 frames_per_token=FRAMES_PER_TOKEN, attn_impl="auto"):
    """The serving slice's engine (one CUDA graph a grid point with
    ``graphs``) on models computing in bf16 on float32 parameters (flax's
    ``dtype=``) at the recipes' widths with ``attn_impl``, from SEED; CPU
    statistics in its normalizers, which the engine moves to the card."""
    from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
    from parakeet_tpu_torch.ops.normalizer import ZScore
    from parakeet_tpu_torch.serving import TTSEngine
    gen = torch.Generator().manual_seed(SEED)
    am = FastSpeech2(IDIM, ODIM, attn_impl=attn_impl, dtype=torch.bfloat16,
                     **FS2_CONFIG)
    voc = PWGGenerator(**PWG_CONFIG, dtype=torch.bfloat16)
    seeded_init_(am, gen)
    seeded_init_(voc, gen)
    with torch.no_grad():
        am.duration_predictor.stack.linear.weight.mul_(DURATION_SPREAD)
        am.duration_predictor.stack.linear.bias.fill_(DURATION_BIAS)
    am = am.to("cuda").eval()
    voc = voc.to("cuda").eval()
    am_norm = ZScore(torch.randn(ODIM, generator=gen) - 5.0,
                     torch.rand(ODIM, generator=gen) + 0.5)
    voc_norm = ZScore(am_norm.mu + 0.1, am_norm.sigma * 1.1)
    return TTSEngine(am, voc=voc, am_norm=am_norm, voc_norm=voc_norm,
                     text_buckets=text_buckets, batch_buckets=batch_buckets,
                     frames_per_token=frames_per_token, graphs=graphs)


def phase_slice(record):
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.serving import Request

    engine = build_engine(graphs=False)
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


def _named(kernels, part):
    """Launches of the kernels whose profiler name contains ``part``."""
    return sum(n for name, n in kernels.items() if part in name)


def _timed_chunks(engine):
    """Log (text bucket, requests, wall s) of each chunk ``engine`` runs;
    the wall time ends with the host copy of the audio."""
    log = []

    def run_chunk(chunk, tb, out, _inner=engine._run_chunk):
        t0 = time.perf_counter()
        _inner(chunk, tb, out)
        log.append((tb, len(chunk), time.perf_counter() - t0))

    engine._run_chunk = run_chunk
    return log


def phase_serving_graphs():
    """The serving slice as captured programs: a graph engine over the
    default grid, built like the eager one (CPU statistics in its
    normalizers), captures one CUDA graph a grid point; the six requests
    through it give the eager engine's wavs bit for bit; K1's wrapper
    launches nothing while they run (no capture on the main path), and
    the profiler finds ``pwg_layer_kernel<64, false>`` 30 times a chunk
    in their replays and no K4a.  Prints each chunk's wall time, graphs
    against eager in turns, and the graphs' memory."""
    from parakeet_tpu_torch.benchmarks.common import (PROFILE_TRIES,
                                                      profiled_kernels)
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.serving import Request
    grid = dict(batch_buckets=GRAPH_BATCH_BUCKETS,
                frames_per_token=GRAPH_FRAMES_PER_TOKEN)
    eager = build_engine(graphs=False, **grid)
    graphs = build_engine(graphs=True, **grid)
    if graphs.am_norm.mu.device.type != "cuda":
        raise AssertionError("the graph engine left its statistics on "
                             f"{graphs.am_norm.mu.device}")
    eager.warmup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    n_programs = graphs.warmup()
    capture_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - before
    if n_programs != len(TEXT_BUCKETS) * len(GRAPH_BATCH_BUCKETS):
        raise AssertionError(f"warmup captured {n_programs} programs")
    gen = torch.Generator().manual_seed(SEED + 2)
    reqs = [Request(ids=torch.randint(1, IDIM, (n,), generator=gen).tolist(),
                    utt_id=f"u{i}", seed=100 + i)
            for i, n in enumerate(REQUEST_LENGTHS)]
    logs = {"eager": _timed_chunks(eager), "graphs": _timed_chunks(graphs)}
    walls = {"eager": [], "graphs": []}
    results = {}
    for name in ("eager", "graphs", "graphs", "eager"):
        engine = eager if name == "eager" else graphs
        logs[name].clear()
        k1.fused_residual_stack.launches = 0
        results[name] = engine.synthesize(reqs)
        walls[name].append([w for _, _, w in logs[name]])
        if name == "graphs" and k1.fused_residual_stack.launches != 0:
            raise AssertionError(
                f"graphs: K1's wrapper launched "
                f"{k1.fused_residual_stack.launches} times on replays")
    for want, got in zip(results["eager"], results["graphs"]):
        if not (want.n_frames == got.n_frames
                and np.array_equal(want.wav, got.wav)):
            diff = (float(abs(want.wav - got.wav).max())
                    if want.wav.shape == got.wav.shape else None)
            raise AssertionError(f"{want.utt_id}: graph wav differs from "
                                 f"the eager one ({want.n_frames} and "
                                 f"{got.n_frames} frames, max abs diff "
                                 f"{diff})")
    chunks = [(tb, n) for tb, n, _ in logs["graphs"]]
    replays = sum(p.replays for p in graphs._programs.values())
    kernels, _, _ = profiled_kernels(lambda: graphs.synthesize(reqs))
    replays = sum(p.replays for p in graphs._programs.values()) - replays
    n_k1 = _named(kernels, K1_KERNEL)
    if (replays != PROFILE_TRIES * len(chunks)
            or _named(kernels, K4A_KERNEL)
            or n_k1 != PWG_CONFIG["layers"] * len(chunks)):
        raise AssertionError(f"graphs: {len(chunks)} chunks in "
                             f"{replays} replays ran {kernels}")
    tb, n = chunks[-1]                  # the main path's last chunk
    key = (tb, graphs._batch_bucket(n))
    kernels, n_kernels, busy_ms = profiled_kernels(graphs._programs[key])
    if _named(kernels, K1_KERNEL) != PWG_CONFIG["layers"]:
        raise AssertionError(f"a replay of {key} ran {kernels}")
    print(f"serving graphs: {n_programs} programs captured in "
          f"{capture_s:.2f} s (text {TEXT_BUCKETS} x batch "
          f"{GRAPH_BATCH_BUCKETS}, {GRAPH_FRAMES_PER_TOKEN} frames a token, "
          f"one shared pool), reserved {held / 2 ** 30:.3f} GiB more after "
          f"warmup, {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB in all; "
          f"{len(reqs)} requests bitwise the eager engine's; their "
          f"{len(chunks)} replays ran {n_k1} x {K1_KERNEL} (profiler), "
          f"its wrapper 0; a replay of {key}: {n_kernels} kernels and "
          f"copies in all, the card busy {busy_ms:.3f} ms")
    print("serving chunks (text bucket, requests) " + str(chunks)
          + ", wall s, eager, graphs, graphs, eager: " + "; ".join(
              f"{walls['eager'][0][i]:.4f}, {walls['graphs'][0][i]:.4f}, "
              f"{walls['graphs'][1][i]:.4f}, {walls['eager'][1][i]:.4f}"
              for i in range(len(chunks))))


def phase_e2e():
    """``bench.py``'s program through ``benchmarks/e2e_rtf.py`` in bf16
    and float32, 'dense' against 'flash' in turns (dense, flash, flash,
    dense; float32 once each): each run's graph gives the eager program's
    wav bit for bit, and a replay holds K1 30 times and, with 'flash',
    K4a 8 times."""
    from parakeet_tpu_torch.benchmarks import e2e_rtf
    for dtype, order in (("bfloat16", ("dense", "flash", "flash", "dense")),
                         ("float32", ("dense", "flash"))):
        runs = {"dense": [], "flash": []}
        for impl in order:
            rec = e2e_rtf.main(["--dtype", dtype, "--attn-impl", impl])
            n_k1 = _named(rec["replay_kernels"], K1_KERNEL)
            n_k4 = _named(rec["replay_kernels"], K4A_KERNEL)
            want_k4 = E2E_ATTN_LAYERS if impl == "flash" else 0
            if not (rec["value"] > 0 and rec["graph_matches_eager"]
                    and n_k1 == PWG_CONFIG["layers"] and n_k4 == want_k4
                    and rec["launches"] == {"K1": n_k1, "K4a": n_k4}):
                raise AssertionError(f"e2e {dtype} {impl}: {rec}")
            runs[impl].append(rec)
        print(f"e2e {dtype} (graph ms | eager ms | RTF | MFU % | busy ms "
              f"in a replay), {', '.join(order)}: " + "; ".join(
                  f"{r['graph_ms']:.3f} | {r['eager_ms']:.3f} | "
                  f"{r['value']:.6f} | {r['mfu_pct']:.2f} | "
                  f"{r['replay_busy_ms']:.3f}"
                  for r in (runs["dense"][0], *runs["flash"],
                            *runs["dense"][1:]))
              + f"; {runs['dense'][0]['flops'] / 1e12:.4f} TFLOP a call; "
              "each graph bitwise its eager program, K1 x 30 (and K4a x "
              f"{E2E_ATTN_LAYERS} with flash) in a replay")
    e2e_cast_yardstick()


def e2e_cast_yardstick():
    """The yardstick of the bf16 program: ``bench.py``'s program (one CUDA
    graph, 'auto') as built now (flax's ``dtype=``: float32 parameters,
    bf16 products) and as the port built it before, the same weights
    rounded to bf16 (``module.to(torch.bfloat16)``), timed in turns (cast,
    new, new, cast).  The two compute different functions, so only
    their finiteness and distance are printed beside the times."""
    from parakeet_tpu_torch.benchmarks.common import (SynthesisProgram,
                                                      build_models)
    from parakeet_tpu_torch.benchmarks.e2e_rtf import MAX_FRAMES, TEXT_LEN
    cuda = torch.device("cuda")
    programs = {}
    for name, dtype in (("new", torch.bfloat16), ("cast", torch.float32)):
        fs2, pwg = build_models(dtype, "auto", cuda)
        if name == "cast":
            fs2, pwg = fs2.to(torch.bfloat16), pwg.to(torch.bfloat16)
        program = SynthesisProgram(fs2, pwg, batch=1, text_len=TEXT_LEN,
                                   max_frames=MAX_FRAMES)
        programs[name] = (program, program.capture())
    wavs = {name: g()[0].float() for name, (_, g) in programs.items()}
    if not all(torch.isfinite(w).all() for w in wavs.values()):
        raise AssertionError("e2e yardstick: a non-finite wav")
    [cast_a, cast_b], [new_a, new_b] = in_turns(
        programs["new"][1], programs["cast"][1], E2E_YARDSTICK_REPS)
    dist = ((wavs["new"] - wavs["cast"]).abs().max()
            / wavs["new"].abs().max()).item()
    print(f"e2e bf16 yardstick (one graph, 'auto', median of "
          f"{E2E_YARDSTICK_REPS} replays, cast, new, new, cast): flax's "
          f"dtype= {new_a:.3f}, {new_b:.3f} ms; cast parameters "
          f"{cast_a:.3f}, {cast_b:.3f} ms; new over cast "
          f"{(new_a + new_b) / (cast_a + cast_b):.3f}; the two wavs "
          f"{dist:.4g} of the range apart, both finite")


def phase_stream():
    """``pwg_streaming_inference`` on the card (one captured graph for the
    window, ``pwg_window_program``, replayed per window) bitwise the
    eager windows, and against one-shot ``pwg_inference``, at
    ``bench.py``'s vocoder widths in bf16."""
    from parakeet_tpu_torch.benchmarks.common import build_models
    from parakeet_tpu_torch.models.parallel_wavegan import (
        pwg_inference, pwg_streaming_inference, pwg_window_program)
    _, pwg = build_models(torch.bfloat16, "dense", torch.device("cuda"))
    gen = torch.Generator().manual_seed(SEED + 11)
    mel = torch.randn((1, STREAM_FRAMES, ODIM), generator=gen).cuda()
    noise = torch.randn((1, STREAM_FRAMES * pwg.upsample_factor, 1),
                        generator=gen).cuda()
    program = pwg_window_program(pwg, mel, noise, chunk_frames=STREAM_CHUNK)
    with torch.no_grad():
        full = pwg_inference(pwg, mel, noise=noise)
        eager = pwg_streaming_inference(pwg, mel, noise,
                                        chunk_frames=STREAM_CHUNK)
        got, again = (pwg_streaming_inference(
            pwg, mel, noise, chunk_frames=STREAM_CHUNK, program=program)
            for _ in range(2))
    torch.cuda.synchronize()
    windows = -(-STREAM_FRAMES // STREAM_CHUNK)
    if not (program.replays == 2 * windows and torch.equal(got, again)
            and torch.equal(got, eager)):
        raise AssertionError(f"streaming: {program.replays} replays of "
                             f"{windows} windows twice, or the two runs "
                             "differ from each other or the eager windows")
    err, tol = _hold("streaming against one-shot", got, full,
                     STREAM_REL_TOL)
    print(f"streaming: {STREAM_FRAMES} frames in {windows} windows of "
          f"{STREAM_CHUNK} (one graph, {program.replays} replays over two "
          f"runs, bitwise the eager windows), against one-shot max abs "
          f"err {err:.4g} "
          f"(tol {tol:.4g})")


def phase_longform():
    """``benchmarks/longform_rtf.py``, one timed iteration: 'dense' and
    'auto' (K4a at dk 96, from 512 frames on: encoder and decoder) in one
    graph each."""
    from parakeet_tpu_torch.benchmarks import longform_rtf
    recs = longform_rtf.main(["--iters", "1"])
    for rec in recs:
        n_k4 = _named(rec["replay_kernels"], K4A_KERNEL)
        want = E2E_ATTN_LAYERS if rec["attn_impl"] == "auto" else 0
        if not (rec["value"] > 0 and rec["graph_matches_eager"]
                and n_k4 == want):
            raise AssertionError(f"longform: {rec}")
    print("longform (graph ms | eager ms | RTF | busy ms in a replay): "
          + "; ".join(f"{r['attn_impl']} {r['graph_ms']:.3f} | "
                      f"{r['eager_ms']:.3f} | {r['value']:.6f} | "
                      f"{r['replay_busy_ms']:.3f}" for r in recs))


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


def bound(n_bytes, flops, dtype, peak_flops=None):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``flops`` operations on ``dtype`` operands (at
    ``peak_flops``, by default the type's peak): {bound_ms, bound_by}."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / (peak_flops or PEAK_FLOPS[dtype])
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _record(name, source, replaces, errs, ms, plain_ms, limit,
            library_ms=None):
    return {"name": name, "route": "cuda",
            "source": f"parakeet_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(e for _, (e, _) in errs), "ms": ms,
            "plain_ms": plain_ms, **limit, "library_ms": library_ms}


def k2b_passes(k2, saved, c16, wg16, wso16, dxo, dsk, dil):
    """Each K2b pass's median time over one group (CUDA events around its
    launches), the bytes it must move (from the shapes) and the rate."""
    b, t, cr = dxo.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = k2.time_group_backward_passes(saved, c16, wg16, wso16, dxo, dsk,
                                       dilations=dil)
    moved = k2.k2b_pass_bytes(b, t, cr, c16.shape[-1], len(dil),
                              k2.k2b_chunks(b * t, k2.k2b_parts(cr, sms))[0])
    print(f"K2b passes B={b} T={t} residual {cr} (median ms over the group, "
          "bytes reckoned from the shapes, GB/s): " + ", ".join(
              f"{k} {ms[k]:.4f} ms {moved[k] / 1e6:.1f} MB "
              f"{moved[k] / ms[k] / 1e6:.0f} GB/s" for k in ms)
          + f"; sum {sum(ms.values()):.4f} ms, {sum(moved.values()) / 1e6:.1f}"
          f" MB, {sum(moved.values()) / sum(ms.values()) / 1e6:.0f} GB/s")


def phase_k2(parent=None):
    """K2a and K2b against their plain versions on one group of ten
    layers of the recipe's stack, at its residual width 64 and at 128;
    returns their records (K2a, K2b at 64, K2a, K2b at 128).  With
    ``parent`` (as ``phase_k1``), also times the parent's K2a at 64, in
    turns."""
    gen = torch.Generator().manual_seed(SEED + 3)
    return (*k2_check(gen, 64, parent),
            *k2_check(gen, CR128, None, "_cr128"))


def k2_check(gen, cr, parent, suffix=""):
    """phase_k2 at residual width ``cr``: K2a and K2b at the small and the
    training shape, held to their plain versions and to a second run,
    timed, K2b pass by pass; returns their records at the training
    shape."""
    from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    stack = ResidualStack(**stack_widths(cr))
    seeded_init_(stack, gen)
    stack = stack.cuda()
    per = PWG_CONFIG["layers"] // PWG_CONFIG["stacks"]
    dil = stack.dilations()[:per]
    with torch.no_grad():
        wg, wso, bso = k1.pack_stack_weights(stack.fused_weights(), cr, ODIM)
    wg16 = wg[:per].to(torch.bfloat16).contiguous()
    wso16 = wso[:per].to(torch.bfloat16).contiguous()
    bso = bso[:per].contiguous()
    for b, t in (SMALL, (TRAIN_B, TRAIN_T)):
        x = torch.randn((b, t, cr), generator=gen).cuda()
        c16 = torch.randn((b, t, ODIM), generator=gen).cuda().to(
            torch.bfloat16)
        fwd = (lambda: k1.fused_group_forward_save(
            x, c16, wg16, wso16, bso, dilations=dil))
        got = fwd()
        ref = k1.group_forward_reference(x, c16, wg16, wso16, bso,
                                         dilations=dil)
        again_a = fwd()
        torch.cuda.synchronize()
        held_a = [(n, _hold(f"K2a {n} B={b} T={t} residual {cr}", g, r,
                            K2_REL_TOL))
                  for n, g, r in zip(("x_next", "skip", "saved"), got, ref)]
        if not all(torch.equal(u, v) for u, v in zip(got, again_a)):
            raise AssertionError("K2a: two runs gave different results")
        dxo = torch.randn((b, t, cr), generator=gen).cuda()
        dsk = torch.randn((b, t, cr), generator=gen).cuda()
        bwd = (lambda: k2.fused_group_backward(
            got[2], c16, wg16, wso16, dxo, dsk, dilations=dil))
        got_b = bwd()
        ref_b = k2.group_backward_reference(got[2], c16, wg16, wso16, dxo,
                                            dsk, dilations=dil)
        again = bwd()
        torch.cuda.synchronize()
        names = ("dx", "dc", "dwg", "dwso", "dbso")
        held_b = [(n, _hold(f"K2b {n} B={b} T={t} residual {cr}", g, r,
                            K2_REL_TOL))
                  for n, g, r in zip(names, got_b, ref_b)]
        if not all(torch.equal(u, v) for u, v in zip(got_b, again)):
            raise AssertionError("K2b: two runs gave different gradients")
        ms_a, plain_a = cuda_ms(fwd, 10), cuda_ms(
            lambda: k1.group_forward_reference(x, c16, wg16, wso16, bso,
                                               dilations=dil), 3)
        ms_b, plain_b = cuda_ms(bwd, 10), cuda_ms(
            lambda: k2.group_backward_reference(got[2], c16, wg16, wso16,
                                                dxo, dsk, dilations=dil), 3)
        print(f"K2a B={b} T={t} residual {cr} (one group of {per} layers): "
              f"{_report('K2a', held_a)}; bit-identical on a second run; "
              f"kernel {ms_a:.4f} ms ({ms_a / per:.4f} a layer), plain "
              f"{plain_a:.4f} ms (median); "
              + layer_traffic(k1, b, t, ms_a, per, 1, True, cr))
        if parent is not None and b == TRAIN_B:
            theirs, ours = in_turns(fwd, lambda: parent.fused_group_forward_save(
                x, c16, wg16, wso16, bso, dilations=dil), 10)
            print(f"K2a B={b} T={t}, parent, change, change, parent: "
                  f"{theirs[0]:.4f}, {ours[0]:.4f}, {ours[1]:.4f}, "
                  f"{theirs[1]:.4f} ms; parent "
                  + layer_traffic(k1, b, t, statistics.mean(theirs), per, 1,
                                  True))
        print(f"K2b B={b} T={t} residual {cr}: {_report('K2b', held_b)}; "
              f"bit-identical on a second run; kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms (median)")
        k2b_passes(k2, got[2], c16, wg16, wso16, dxo, dsk, dil)
    row_layers = b * t * per
    limit_a = bound(nbytes(x, c16, wg16, wso16, bso, *got),
                    row_layers * stack_fwd_flops(cr), torch.bfloat16)
    limit_b = bound(nbytes(got[2], c16, wg16, wso16, dxo, dsk, *got_b),
                    row_layers * stack_bwd_flops(cr), torch.bfloat16)
    return (_record(f"pwg_residual_stack_fwd_save{suffix}", K1_SOURCE[cr],
                    "parakeet_tpu/ops/pallas/pwg_stack.py:93", held_a, ms_a,
                    plain_a, limit_a),
            _record(f"pwg_residual_stack_bwd{suffix}", K2B_SOURCE[cr],
                    "parakeet_tpu/ops/pallas/pwg_stack_train.py:76", held_b,
                    ms_b, plain_b, limit_b))


def traffic(moved, ms):
    """``moved`` bytes in ``ms``: GB, GB/s and the share of 3.35 TB/s."""
    floor_ms = 1e3 * moved / PEAK_BYTES_PER_S
    return (f"{moved / 1e9:.4f} GB, {moved / ms / 1e6:.0f} GB/s, "
            f"{100 * floor_ms / ms:.1f}% of 3.35 TB/s (floor "
            f"{floor_ms:.4f} ms)")


def k3_passes(k3, saved, dlog, wk, slope, ms_c):
    """K3b's passes (median ms of the nine layer passes summed and of the
    reduction, CUDA events around each launch) with the bytes of
    ``k3b_bytes``, and K3c's call of ``ms_c`` with those of ``k3c_bytes``
    (scratch and partials counted as SM-to-L2 traffic)."""
    b, t = dlog.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = k3.time_disc_backward_passes(saved, dlog, wk, slope=slope)
    moved = k3.k3b_bytes(b, t, sms=sms)
    print(f"K3b passes B={b} T={t} (median ms, bytes of k3b_bytes): "
          + ", ".join(f"{k} {ms[k]:.4f} ms, {traffic(moved[k], ms[k])}"
                      for k in ms)
          + f"; sum {sum(ms.values()):.4f} ms, "
          + traffic(sum(moved.values()), sum(ms.values())))
    moved_c = k3.k3c_bytes(b, t, sms=sms)
    held = k3.k3c_buffer_bytes(b, t, sms=sms)
    total = sum(moved_c.values())
    print(f"K3c B={b} T={t} (bytes of k3c_bytes: kernel "
          f"{moved_c['kernel'] / 1e9:.4f} GB, reduce "
          f"{moved_c['reduce'] / 1e9:.4f} GB): {ms_c:.4f} ms, "
          + traffic(total, ms_c) + f"; partials "
          f"{held['partials'] / 1e6:.1f} MB + scratch "
          f"{held['scratch'] / 1e6:.1f} MB")


def k3a_calls(k3, h, wk, bk, got, ms_a, ms_an):
    """K3a's grid, waves and blocks an SM, and its two calls' bytes
    (``k3a_bytes``), GB/s and share of their bounds (the one without
    saving bound by FLOP)."""
    b, t, _ = h.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = k3.k3a_blocks_per_sm()
    grid = k3.k3a_grid(b, t)
    parts = []
    for save, ms, outs in ((True, ms_a, got), (False, ms_an, got[:1])):
        limit = bound(nbytes(h, wk, bk, *outs), b * t * DISC_FWD_FLOPS,
                      torch.bfloat16)
        parts.append(
            f"{'with' if save else 'without'} saving {ms:.4f} ms, "
            f"{traffic(k3.k3a_bytes(b, t, save), ms)} (k3a_bytes); bound "
            f"{limit['bound_ms']:.4f} ms ({limit['bound_by']}), "
            f"{100 * limit['bound_ms'] / ms:.1f}% of it")
    print(f"K3a B={b} T={t}: grid {grid} blocks, {per_sm} an SM, "
          f"{grid / (per_sm * sms):.2f} waves on {sms} SMs; "
          + "; ".join(parts))


def phase_k3(parent=None):
    """K3a, K3b and K3c against their plain versions, and K3c against K3b;
    returns their records.  With ``parent`` (the parent checkout's
    pwg_disc module), also times the parent's K3a (with and without
    saving), K3b and K3c on the same inputs, in turns."""
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
        nosave = (lambda: k3.fused_disc_forward(h, wk, bk, slope=slope,
                                                save=False))
        got_n = nosave()
        ref_n = k3.disc_forward_reference(h, wk, bk, slope=slope,
                                          save=False)
        torch.cuda.synchronize()
        held_n = [("logits", _hold(f"K3a without saving B={b} T={t}",
                                   got_n[0], ref_n[0], K3_REL_TOL))]
        if got_n[1] is not None or not torch.equal(got_n[0], got[0]):
            raise AssertionError(f"K3a B={b} T={t}: the logits without "
                                 "saving are not those with saving")
        # K3a's calls back to back: a single call's ~0.2 ms is close to
        # the host's time to issue it
        ms_a, plain_a = cuda_ms_per_call(fwd, 5), cuda_ms(
            lambda: k3.disc_forward_reference(h, wk, bk, slope=slope), 3)
        ms_an, plain_an = cuda_ms_per_call(nosave, 5), cuda_ms(
            lambda: k3.disc_forward_reference(h, wk, bk, slope=slope,
                                              save=False), 3)
        ms_b, plain_b = cuda_ms(bwd, 10), cuda_ms(
            lambda: k3.disc_backward_reference(got[1], dlog, wk,
                                               slope=slope), 3)
        print(f"K3a B={b} T={t} (with save): {_report('K3a', held_a)}; "
              f"kernel {ms_a:.4f} ms a call (10 back to back), plain "
              f"{plain_a:.4f} ms (median); without save: "
              f"{_report('K3a', held_n)}, bitwise the logits with save; "
              f"kernel {ms_an:.4f} ms a call, plain {plain_an:.4f} ms")
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
        if b == TRAIN_B:
            k3a_calls(k3, h, wk, bk, got, ms_a, ms_an)
            k3_passes(k3, got[1], dlog, wk, slope, ms_c)
        if parent is not None and b == TRAIN_B:
            for tag, ours, theirs, timer in (
                    ("K3a with saving (10 back to back, a call)", fwd,
                     lambda: parent.fused_disc_forward(h, wk, bk,
                                                       slope=slope,
                                                       save=True),
                     cuda_ms_per_call),
                    ("K3a without saving (the same)", nosave,
                     lambda: parent.fused_disc_forward(h, wk, bk,
                                                       slope=slope,
                                                       save=False),
                     cuda_ms_per_call),
                    ("K3b", bwd, lambda: parent.fused_disc_backward(
                        got[1], dlog, wk, slope=slope, need_dx=True,
                        need_weights=True), cuda_ms),
                    ("K3c", rc, lambda: parent.fused_disc_backward_recompute(
                        h16, dlog, wk, bk, slope=slope, need_dx=True,
                        need_weights=True), cuda_ms)):
                p_ms, c_ms = in_turns(ours, theirs, 10, timer)
                print(f"{tag} B={b} T={t}, parent, change, change, parent: "
                      f"{p_ms[0]:.4f}, {c_ms[0]:.4f}, {c_ms[1]:.4f}, "
                      f"{p_ms[1]:.4f} ms")
    rows = b * t
    limit_a = bound(nbytes(h, wk, bk, *got), rows * DISC_FWD_FLOPS,
                    torch.bfloat16)
    limit_b = bound(nbytes(got[1], dlog, wk, *got_b),
                    rows * DISC_BWD_FLOPS, torch.bfloat16)
    limit_c = bound(nbytes(h16, dlog, wk, bk, *got_c),
                    rows * DISC_RC_FLOPS, torch.bfloat16)
    return (_record("pwg_disc_fwd", "pwg_disc.cu",
                    "parakeet_tpu/ops/pallas/pwg_disc.py:143",
                    held_a + held_n, ms_a, plain_a, limit_a),
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


def expected_launches(disc_on, vjp_mode="save", cr=64):
    """Kernel launches of one train step at the recipe's widths (residual
    ``cr``).

    Generator update: K2a once per layer (twice at cr 128,
    ``k1_layer_launches``); K2b per group a prep, gate, dw
    and dx per layer, and one reduction (``k2b_launches``).  GAN steps
    add the discriminator on the fake (K3a), its input gradient only (the
    discriminator's weights are constants there), the regeneration of the
    fake without a gradient (K1, as K2a per layer), and the discriminator
    update: K3a on real and fake, each with the gradients of h and the
    weights.  With ``vjp_mode='save'`` K3a saves and K3b runs for the
    input gradient and for each update (``k3b_launches``: a pass per
    layer, and one reduction with the weights); with 'recompute' K3a saves
    nothing and K3c runs instead (``k3c_launches``: the kernel, and one
    reduction with the weights).
    """
    from parakeet_tpu_torch.ops.kernels.pwg_disc import (k3b_launches,
                                                        k3c_launches)
    from parakeet_tpu_torch.ops.kernels.pwg_stack import k1_layer_launches
    from parakeet_tpu_torch.ops.kernels.pwg_stack_train import k2b_launches
    layers, stacks = PWG_CONFIG["layers"], PWG_CONFIG["stacks"]
    n = {"K1": 0, "K2a": layers * k1_layer_launches(cr),
         "K2b": stacks * k2b_launches(layers // stacks), "K3a": 0,
         "K3b": 0, "K3c": 0}
    if disc_on:
        n.update(K1=layers * k1_layer_launches(cr), K3a=1 + 2)
        fn = k3b_launches if vjp_mode == "save" else k3c_launches
        n["K3b" if vjp_mode == "save" else "K3c"] = (
            fn(True, False) + 2 * fn(True, True))
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


def phase_k4a_graphs():
    """K4a against its plain version, unblocked and blocked at its key
    tile, in float32 and bf16, at each shape it runs inside the synthesis
    graphs (``K4A_GRAPH_SHAPES``, tolerance ``k4a_graph_tol``); prints
    its time beside the plain version's and SDPA's forward."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    gen = torch.Generator().manual_seed(SEED + 12)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(FS2_DK)
    for t, n_valid in K4A_GRAPH_SHAPES:
        kv_valid = (torch.arange(t)[None] < n_valid).to(torch.int32).cuda()
        mask = kv_valid[:, None, None, :].bool()
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((1, FS2_HEADS, t, FS2_DK), generator=gen)
                       .cuda().to(dtype) for _ in range(3))
            args = (q, k, v, torch.ones_like(kv_valid), kv_valid)
            o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
            o2, lse2 = k4.flash_attention_forward(*args, sm_scale=scale)
            ref_o, ref_lse = k4.flash_attention_reference(*args,
                                                          sm_scale=scale)
            block_k = k4.k4a_block_k(dtype, FS2_DK)
            blk_o, blk_lse = k4.flash_attention_reference(
                *args, sm_scale=scale, block_k=block_k)
            torch.cuda.synchronize()
            tol = k4a_graph_tol(dtype, n_valid)
            tag = (f"B=1 T={t} ({n_valid} keys valid) H={FS2_HEADS} "
                   f"dk={FS2_DK} {dtype}")
            held = [(n, _hold(f"K4a {n} {tag}", got, ref, tol))
                    for n, got, ref in (
                        ("o", o, ref_o), ("lse", lse, ref_lse),
                        (f"o (block_k {block_k})", o, blk_o),
                        (f"lse (block_k {block_k})", lse, blk_lse))]
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"K4a {tag}: two runs gave different "
                                     "outputs")
            ms = cuda_ms(lambda: k4.flash_attention_forward(
                *args, sm_scale=scale), 10)
            plain = cuda_ms(lambda: k4.flash_attention_reference(
                *args, sm_scale=scale), 5)
            lib = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                       scale=scale), 10)
            print(f"K4a in the graphs, {tag}: {_report('K4a', held)}; "
                  f"bit-identical on a second run; kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, scaled_dot_product_attention "
                  f"forward {lib:.4f} ms (median)")


K4_NAMES = {"K4a": "flash_attention_fwd", "K4b": "flash_attention_bwd_dkv",
            "K4c": "flash_attention_bwd_dq"}


def sdpa_backend(q, k, v, mask, scale):
    """The backend PyTorch's dispatcher picks for
    ``scaled_dot_product_attention`` on these inputs, by name."""
    from torch.nn.attention import SDPBackend
    choice = int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False,
                                         scale=scale))
    return next((n for n in dir(SDPBackend) if n.isupper()
                 and int(getattr(SDPBackend, n)) == choice), str(choice))


def _k4_case(gen, q_valid, kv_valid, h, dk, dtype):
    """K4a, K4b and K4c against their plain versions (K4a also against its
    blocked plain version at its own key tile) on fresh inputs from
    ``gen`` of ``q_valid``'s (B, T) with ``h`` heads of ``dk``, printed
    with their times; returns {kernel: (held, ms, plain_ms, (bytes, flops)
    this data needs, library_ms)}."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, t = kv_valid.shape
    scale = 1.0 / math.sqrt(dk)
    # score pairs this data needs: valid query rows times valid keys, per
    # item and head
    pairs = h * (q_valid.sum(1).double()
                 * kv_valid.sum(1).double()).sum().item()
    q, k, v, do = (torch.randn((b, h, t, dk), generator=gen).cuda()
                   .to(dtype) for _ in range(4))
    args = (q, k, v, q_valid, kv_valid)
    o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
    o2, lse2 = k4.flash_attention_forward(*args, sm_scale=scale)
    ref_o, ref_lse = k4.flash_attention_reference(*args, sm_scale=scale)
    block_k = k4.k4a_block_k(dtype, dk)
    blk_o, blk_lse = k4.flash_attention_reference(
        *args, sm_scale=scale, block_k=block_k)
    di = (o.float() * do.float()).sum(-1)
    bwd_args = args + (do, lse, di)

    def bwd():
        return (k4.flash_attention_dq(*bwd_args, sm_scale=scale),
                *k4.flash_attention_dkv(*bwd_args, sm_scale=scale))

    def plain_bwd():
        return (k4.flash_attention_dq_reference(*bwd_args, sm_scale=scale),
                *k4.flash_attention_dkv_reference(*bwd_args,
                                                  sm_scale=scale))

    got, again, ref = bwd(), bwd(), plain_bwd()
    torch.cuda.synchronize()
    tol = K4_REL_TOL[str(dtype).split(".")[1]]
    tag = f"B={b} T={t} H={h} dk={dk} {dtype}"
    held_a = [("o", _hold(f"K4a o {tag}", o, ref_o, tol)),
              ("lse", _hold(f"K4a lse {tag}", lse, ref_lse, tol)),
              (f"o (block_k {block_k})",
               _hold(f"K4a o {tag} block_k={block_k}", o, blk_o, tol)),
              (f"lse (block_k {block_k})",
               _hold(f"K4a lse {tag} block_k={block_k}", lse, blk_lse,
                     tol))]
    held_b = [(n, _hold(f"K4b {n} {tag}", g, r, tol))
              for n, g, r in zip(("dk", "dv"), got[1:], ref[1:])]
    held_c = [("dq", _hold(f"K4c dq {tag}", got[0], ref[0], tol))]
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"K4a {tag}: two runs gave different outputs")
    if not all(torch.equal(u, w) for u, w in zip(got, again)):
        raise AssertionError(f"K4b/K4c {tag}: two runs gave different "
                             "gradients")

    def fwd_bwd(fwd, bwd_fn):
        return fwd(*args, sm_scale=scale), bwd_fn()

    ms_f = cuda_ms(lambda: k4.flash_attention_forward(
        *args, sm_scale=scale), 10)
    plain_f = cuda_ms(lambda: k4.flash_attention_reference(
        *args, sm_scale=scale), 5)
    ms_fb = cuda_ms(lambda: fwd_bwd(k4.flash_attention_forward, bwd), 10)
    plain_fb = cuda_ms(lambda: fwd_bwd(k4.flash_attention_reference,
                                       plain_bwd), 5)
    times = [cuda_ms(lambda f=f: f(*bwd_args, sm_scale=scale), n)
             for f, n in ((k4.flash_attention_dkv, 10),
                          (k4.flash_attention_dkv_reference, 5),
                          (k4.flash_attention_dq, 10),
                          (k4.flash_attention_dq_reference, 5))]
    # the library's attention on the same inputs: PyTorch's
    # scaled_dot_product_attention with the same validity mask; its
    # backward alone (dq, dk and dv in one call) from a graph kept for the
    # timing
    mask = kv_valid[:, None, None, :].bool()
    if not bool(q_valid.all()):
        mask = mask & q_valid[:, None, :, None].bool()
    lib_f = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = sdpa(qg, kg, vg, attn_mask=mask, scale=scale)
    lib_b = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True), 10)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, attn_mask=mask, scale=scale), (qg, kg, vg), do),
        10)
    del lib_out
    dq, dk_, dv = got
    peak = K4_PEAK_FLOPS[dtype]
    work = {"K4a": (nbytes(*args, o, lse), 4 * dk * pairs),
            "K4b": (nbytes(*bwd_args, dk_, dv), 8 * dk * pairs),
            "K4c": (nbytes(*bwd_args, dq), 6 * dk * pairs)}
    backend = sdpa_backend(q, k, v, mask, scale)
    print(f"K4 {tag}: {_report('K4', held_a + held_b + held_c)}; "
          f"o and lse bit-identical on a second run, gradients too;"
          f" bounds (by, products at {peak / 1e12:.0f} TFLOP/s) "
          + ", ".join(f"{n} {lim['bound_ms']:.4f} ms ({lim['bound_by']})"
                      for n, lim in ((n, bound(*w, dtype, peak))
                                     for n, w in work.items()))
          + f"; forward kernel {ms_f:.4f} ms, plain {plain_f:.4f} "
          f"ms; K4b (dk, dv) {times[0]:.4f} ms, plain {times[1]:.4f}"
          f" ms; K4c (dq) {times[2]:.4f} ms, plain {times[3]:.4f} "
          f"ms; forward + "
          f"backward kernels {ms_fb:.4f} ms, plain {plain_fb:.4f} "
          f"ms; scaled_dot_product_attention ({backend}) forward "
          f"{lib_f:.4f} "
          f"ms, backward {lib_b:.4f} ms, forward + backward "
          f"{lib_fb:.4f} ms (median); K4b + K4c "
          f"{times[0] + times[2]:.4f} ms against SDPA's backward "
          f"{lib_b:.4f} ms")
    # K4b's and K4c's library call: SDPA's backward, one call that
    # computes dq, dk and dv
    return {"K4a": (held_a, ms_f, plain_f, work["K4a"], lib_f),
            "K4b": (held_b, *times[:2], work["K4b"], lib_b),
            "K4c": (held_c, *times[2:], work["K4c"], lib_b)}


def k4_source(dk, dtype, kernel="K4a"):
    """The source of ``kernel``'s instance at head width ``dk`` in
    ``dtype``."""
    from parakeet_tpu_torch.ops.kernels.flash_attn import k4_padded_dim
    if k4_padded_dim(dk) > 256:
        return ("flash_attn_wide.cu" if kernel == "K4a"
                else "flash_attn_wide_bwd.cu")
    if k4_padded_dim(dk) == 256:
        return "flash_attn_d256.cu"
    return ("flash_attn_bf16.cu" if dtype == torch.bfloat16
            else "flash_attn.cu")


def _k4_records(cases, suffix, dtype=torch.float32, dk=RECIPE_DK):
    """The kernels line's K4 records from ``_k4_case`` results at head
    width ``dk``: each kernel's worst error, its times summed over
    ``cases`` and its bound from their bytes and operations together."""
    out = {}
    for key, name in K4_NAMES.items():
        source = k4_source(dk, dtype, key)
        runs = [c[key] for c in cases]
        n_bytes = sum(r[3][0] for r in runs)
        flops = sum(r[3][1] for r in runs)
        out[key + suffix] = _record(
            name + suffix, source, "parakeet_tpu/nn/flash.py:88",
            [h for r in runs for h in r[0]], sum(r[1] for r in runs),
            sum(r[2] for r in runs),
            bound(n_bytes, flops, dtype, K4_PEAK_FLOPS[dtype]),
            sum(r[4] for r in runs))
    return out


def phase_k4():
    """K4a, K4b and K4c against their plain versions in float32 and bf16
    at ``K4_SHAPES`` (``_k4_case``); returns their records, keyed 'K4a'
    ... plus the shape's suffix (the times of the shapes that give
    records, float32)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    records = {}
    for b, t, h, dk, lengths, mask_rows, suffix in K4_SHAPES:
        if isinstance(lengths, int):
            lengths = _spread_lengths(gen, b, lengths, t)
        kv_valid = (torch.arange(t)[None] < torch.as_tensor(
            lengths)[:, None]).to(torch.int32).cuda()
        q_valid = (kv_valid.clone() if mask_rows
                   else torch.ones_like(kv_valid))
        for dtype in (torch.float32, torch.bfloat16):
            case = _k4_case(gen, q_valid, kv_valid, h, dk, dtype)
            if dtype == torch.float32 and suffix is not None:
                records.update(_k4_records([case], suffix, dk=dk))
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
    for name, n in totals.items():
        records[name]["launches"] = n
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


def phase_fs2_d512(records):
    """dk 512 (adim 512 over one head, the wide instances at DP 512): the
    FastSpeech2 step of FS2_TRAIN_CONFIG at that width, FS2_D512_STEPS
    float32 steps with 'flash' and with 'dense' from the same seeded
    weights, batches and dropout generator.  Each flash step launches K4a,
    K4b and K4c once a layer (the dense one none), and each step's loss is
    held to the dense one's within FS2_LOSS_REL_TOL.  Sets the dk 512
    records' launches from the flash run."""
    from parakeet_tpu_torch.models import (FastSpeech2, init_fs2_train_state,
                                           make_fs2_train_step)
    from parakeet_tpu_torch.training import build_optimizer, seed_everything
    config = dict(FS2_TRAIN_CONFIG, adim=FS2_D512_DK, aheads=1)
    counters = _k4_counters()
    per_step = config["elayers"] + config["dlayers"]
    runs = {}
    for impl in ("flash", "dense"):
        gen = torch.Generator().manual_seed(SEED + 8)
        model = FastSpeech2(IDIM, ODIM, attn_impl=impl, **config)
        seeded_init_(model, gen)
        model = model.cuda()
        batches = fs2_batches(gen, steps=FS2_D512_STEPS)
        opt = build_optimizer(model.parameters(), "adam", FS2_LR)
        state = init_fs2_train_state(
            model, opt, seed_everything(SEED + 9, device="cuda"))
        step = make_fs2_train_step(model, opt)
        log = []
        for batch in batches:
            before = {k: f.launches for k, f in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            log.append({"ms": 1e3 * (time.perf_counter() - t0),
                        "loss": loss,
                        "launches": {k: f.launches - before[k]
                                     for k, f in counters.items()}})
            want = dict.fromkeys(counters, per_step if impl == "flash" else 0)
            if log[-1]["launches"] != want or not math.isfinite(loss):
                raise AssertionError(f"fs2 at dk {FS2_D512_DK} ({impl}) step "
                                     f"{len(log) - 1}: {log[-1]}")
        runs[impl] = log
    for i, (f, d) in enumerate(zip(runs["flash"], runs["dense"])):
        err = abs(f["loss"] - d["loss"])
        if not err <= FS2_LOSS_REL_TOL * abs(d["loss"]):
            raise AssertionError(f"fs2 at dk {FS2_D512_DK} step {i} loss "
                                 f"{f['loss']} (flash) against {d['loss']} "
                                 "(dense)")
        print(f"fs2 train at dk {FS2_D512_DK} (adim 512 over one head) step "
              f"{i}: flash {f['ms']:.2f} ms, dense {d['ms']:.2f} ms; loss "
              f"{f['loss']:.7g} vs {d['loss']:.7g} (|diff| {err:.3g}, tol "
              f"{FS2_LOSS_REL_TOL * abs(d['loss']):.3g}); launches "
              f"{f['launches']}")
    for name in counters:
        records[f"{name}_dk{FS2_D512_DK}"]["launches"] = sum(
            e["launches"][name] for e in runs["flash"])


def phase_recipe(record, cr128_records):
    """The PWGAN recipe through its CLI, ``--device cuda`` by default:
    RECIPE_STEPS steps from an empty directory, a second run to
    RECIPE_RESUME_STEPS that resumes from the newest snapshot, and a
    straight run to RECIPE_RESUME_STEPS to compare it with.  Sets K3c's
    launches in ``record``.  Then the recipe at residual width 128
    (``recipe_cr128``), which sets the launches of ``cr128_records``."""
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

    def run(name, directory, want, opts=RECIPE_OPTS,
            disc_start=RECIPE_DISC_START, vjp_mode="recompute", cr=64,
            interval=RECIPE_INTERVAL, snapshots=RECIPE_SNAPSHOTS):
        """Train to want[-1] + 1 steps in ``directory`` and check the run:
        the steps it took, each step's launches, finite train and eval
        metrics, the snapshots left and the ledger."""
        log.clear()
        last = want[-1] + 1
        trainer = train.main([
            "--config", RECIPE_CONF, "--train-metadata", str(md["train"]),
            "--dev-metadata", str(md["dev"]), "--output-dir",
            str(out / directory), "--opts", *opts,
            "train_max_steps", str(last)])
        if [s["step"] for s in log] != list(want):
            raise AssertionError(f"recipe {name} run took steps "
                                 f"{[s['step'] for s in log]}, not "
                                 f"{list(want)}")
        for s in log:
            expect = expected_launches(s["step"] >= disc_start, vjp_mode,
                                       cr)
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
        keep = [last - interval * i for i in reversed(range(snapshots))]
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
    train.make_pwg_train_step = timed_step_factory
    try:
        recipe_cr128(out, md, run, counters, cr128_records)
    finally:
        train.make_pwg_train_step = make


def recipe_cr128(out, md, run, counters, records):
    """The recipe's CLI at residual width 128 (CR128_OPTS): RECIPE_CR128_
    STEPS steps with the discriminator ('save') from RECIPE_CR128_DISC_
    START, every step's launches checked (``run`` of ``phase_recipe``:
    K2a and K1 twice a layer); then ``pwgan/synthesize.py`` on its
    snapshot, through a YAML of the same ``--opts``, over the first
    RECIPE_CR128_LINES dev lines: each wav finite with frames x 300
    samples, K1 twice a layer a line, and within K1_REL_TOL of the wav
    that K1's plain version gives.  Sets the launches of the width-128
    records: K1 over the run (its GAN steps, evaluation and synthesis),
    K2a and K2b over its steps."""
    from parakeet_tpu_torch.ops.kernels.pwg_stack import k1_layer_launches
    from parakeet_tpu_torch.recipes.pwgan import synthesize as pwg_syn
    from parakeet_tpu_torch.training import Config
    for f in counters.values():
        f.launches = 0
    steps = RECIPE_CR128_STEPS
    opts = [*CR128_OPTS, "updater.discriminator_train_start_steps",
            str(RECIPE_CR128_DISC_START), "save_interval_steps", str(steps),
            "eval_interval_steps", str(steps), "num_snapshots", "1"]
    tic = time.perf_counter()
    run("cr128", "cr128", range(steps), opts, RECIPE_CR128_DISC_START,
        "save", CR128, steps, 1)
    train_s = time.perf_counter() - tic
    trained = {k: f.launches for k, f in counters.items()}
    if any(trained[k] == 0 for k in ("K1", "K2a", "K2b", "K3a", "K3b")):
        raise AssertionError(f"recipe cr128: launches {trained}")
    conf = out / "cr128.yaml"
    Config.from_yaml(RECIPE_CONF).merge_opts(CR128_OPTS).dump(conf)
    dev = out / "cr128_dev.jsonl"
    dev.write_text("".join(pathlib.Path(md["dev"]).read_text().splitlines(
        True)[:RECIPE_CR128_LINES]))
    argv = ["--config", str(conf), "--checkpoint",
            str(out / "cr128" / "checkpoints" / f"snapshot_iter_{steps}.npz"),
            "--test-metadata", str(dev)]
    k1 = counters["K1"]
    before = k1.launches
    got = pwg_syn.main(argv + ["--output-dir", str(out / "cr128_wavs")])
    syn = k1.launches - before
    plain = _with_plain_k1(pwg_syn.main, argv + [
        "--output-dir", str(out / "cr128_plain")])
    worst = _k1_against_plain("recipe cr128 synthesize.py", got["lines"],
                              plain["lines"], 300)
    want = PWG_CONFIG["layers"] * k1_layer_launches(CR128) * len(got["lines"])
    if len(got["lines"]) != RECIPE_CR128_LINES or syn != want:
        raise AssertionError(f"recipe cr128 synthesize.py: "
                             f"{len(got['lines'])} lines, K1 x {syn}")
    print(f"recipe cr128 ({' '.join(CR128_OPTS)}): {steps} steps in "
          f"{train_s:.1f} s with launches {trained}; pwgan/synthesize.py on "
          f"its snapshot: " + "; ".join(
              f"{r['utt_id']} {r['frames']} frames, vocoder "
              f"{1e3 * r['vocoder_s']:.2f} ms" for r in got["lines"])
          + f"; K1 x {syn}; wavs within {worst:.3g} of their range of K1's "
          f"plain version's (tol {K1_REL_TOL:.3g})")
    for key, rec in records.items():
        rec["launches"] = k1.launches if key == "K1" else trained[key]


def phase_fs2_recipe(records):
    """The FastSpeech2 recipe through its CLI, ``--device cuda`` by
    default, at default.yaml's full widths with 'flash': FS2_RECIPE_EPOCHS
    epochs from an empty directory, a second run to
    FS2_RECIPE_RESUME_EPOCHS that resumes from the newest snapshot, a
    straight run to compare it with, one epoch with 'dense' from the same
    weights (its step 0 against flash's), and aishell3.yaml with
    ``--speaker-dict`` (the concat integration) for one epoch; then
    default.yaml at adim 512 over 2 heads (dk 256) and at adim 384 over
    one head (dk 384; ``FS2_WIDE_OPTS``) for one epoch each and the
    synthesis CLI on each snapshot (``fs2_width_synthesis``).  Sets the dk
    192 K4 records' launches from the three flash runs of default.yaml,
    and the dk 256 and 384 records' from their run and its synthesis."""
    import shutil
    from parakeet_tpu_torch.recipes.fastspeech2 import train
    from parakeet_tpu_torch.recipes.fastspeech2.dump import \
        write_synthetic_dump
    from parakeet_tpu_torch.recipes.synthesis import write_id_maps
    out = pathlib.Path("build") / "chip_smoke_fs2_recipe"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 13,
                              splits=FS2_RECIPE_SPLITS,
                              frames=FS2_RECIPE_FRAMES,
                              phones=FS2_RECIPE_PHONES, n_mels=ODIM,
                              speakers=FS2_RECIPE_SPEAKERS)
    counters = _k4_counters()
    layers = FS2_CONFIG["elayers"] + FS2_CONFIG["dlayers"]
    per_step = dict.fromkeys(counters, layers)
    per_eval = {"K4a": layers, "K4b": 0, "K4c": 0}
    log = []
    make_train, make_eval = train.make_fs2_train_step, train.make_fs2_eval_step

    def counted(make, kind):
        def factory(model, *args, **kwargs):
            fn = make(model, *args, **kwargs)

            def wrapped(state, batch):
                before = {k: f.launches for k, f in counters.items()}
                i = state.step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(state, batch)
                torch.cuda.synchronize()
                entry = {"kind": kind, "step": i,
                         "ms": 1e3 * (time.perf_counter() - t0),
                         "T": tuple(batch["speech"].shape[:2]),
                         "launches": {k: f.launches - before[k]
                                      for k, f in counters.items()}}
                if kind == "train":
                    entry["loss"] = float(result[1]["loss"])
                    entry["lengths"] = {k: batch[k].cpu() for k in (
                        "text", "text_lengths", "speech", "speech_lengths")}
                    entry["q_grad"] = torch.cat([
                        getattr(model.decoder, f"layer_{j}").self_attn.q
                        .weight.grad.flatten()
                        for j in range(FS2_CONFIG["dlayers"])]).clone()
                log.append(entry)
                return result
            return wrapped
        return factory

    def run(name, directory, epochs, want, conf=FS2_RECIPE_CONF,
            impl="flash", speakers=False, opts=(), phones=md["phones"]):
        """Train to ``epochs`` in ``directory``; check the steps it took,
        each step's and eval batch's K4 launches and finite metrics."""
        log.clear()
        argv = ["--config", conf, "--train-metadata", str(md["train"]),
                "--dev-metadata", str(md["dev"]), "--output-dir",
                str(out / directory), "--phones-dict", str(phones)]
        if speakers:
            argv += ["--speaker-dict", str(md["speakers"])]
        trainer = train.main(argv + [
            "--opts", "model.attn_impl", impl, *FS2_RECIPE_ATTN_OPTS,
            *opts, "max_epoch", str(epochs)])
        steps = [e["step"] for e in log if e["kind"] == "train"]
        if steps != list(want):
            raise AssertionError(f"fs2 recipe {name} run took steps {steps},"
                                 f" not {list(want)}")
        for e in log:
            expect = ((per_step if e["kind"] == "train" else per_eval)
                      if impl == "flash" else dict.fromkeys(counters, 0))
            if e["launches"] != expect:
                raise AssertionError(f"fs2 recipe {name} {e['kind']} at "
                                     f"step {e['step']}: launches "
                                     f"{e['launches']}, expected {expect}")
        obs = {k: float(v) for k, v in trainer.observation.items()}
        bad = {k: v for k, v in obs.items() if not math.isfinite(v)}
        if (bad or "eval/loss" not in obs
                or not all(math.isfinite(e["loss"]) for e in log
                           if e["kind"] == "train")):
            raise AssertionError(f"fs2 recipe {name}: metrics {obs}")
        model = trainer.updater.train_state.modules["model"]
        print(f"fs2 recipe {name} run ({conf}, {impl}): steps {steps}, "
              "batch x frames " + ", ".join(
                  f"{e['T'][0]}x{e['T'][1]} {e['kind']} {e['ms']:.1f} ms"
                  for e in log)
              + f"; K4 launches a step {per_step if impl == 'flash' else 0}"
              f", an eval batch {per_eval if impl == 'flash' else 0}; "
              + ", ".join(f"{k} {v:.6g}" for k, v in obs.items()))
        return obs, [dict(e) for e in log], model

    train.make_fs2_train_step = counted(make_train, "train")
    train.make_fs2_eval_step = counted(make_eval, "eval")
    spe = FS2_RECIPE_STEPS_PER_EPOCH
    first_steps = FS2_RECIPE_EPOCHS * spe
    last_steps = FS2_RECIPE_RESUME_EPOCHS * spe
    try:
        for f in counters.values():
            f.launches = 0
        _, flash_log, _ = run("first", "resumed", FS2_RECIPE_EPOCHS,
                              range(first_steps))
        got, _, _ = run("resumed", "resumed", FS2_RECIPE_RESUME_EPOCHS,
                        range(first_steps, last_steps))
        want, _, _ = run("straight", "straight", FS2_RECIPE_RESUME_EPOCHS,
                         range(last_steps))
        totals = {k: f.launches for k, f in counters.items()}
        _, dense_log, _ = run("dense", "dense", 1, range(spe), impl="dense")
        _, _, spk_model = run("aishell3", "aishell3", 1, range(spe),
                              conf=FS2_RECIPE_SPK_CONF, speakers=True)
        # adim 512 over 2 heads (K4 at DP = 256) and adim 384 over one
        # head (the wide instances): each from counts set to 0 here to
        # after its synthesis
        t_wide = time.perf_counter()
        zh = write_id_maps(out / "zh", "zh")
        wide = {}
        for dk, opts in FS2_WIDE_OPTS.items():
            for f in counters.values():
                f.launches = 0
            _, wide_log, wide_model = run(f"dk {dk}", f"d{dk}", 1,
                                          range(spe), opts=opts,
                                          phones=zh["phones"])
            wide[dk] = ({k: f.launches for k, f in counters.items()},
                        wide_log, wide_model)
    finally:
        train.make_fs2_train_step = make_train
        train.make_fs2_eval_step = make_eval
    totals_wide = {}
    for dk, (trained, wide_log, wide_model) in wide.items():
        snapshot = out / f"d{dk}" / "checkpoints" / f"snapshot_iter_{spe}.npz"
        synth = fs2_width_synthesis(out, zh, snapshot, dk)
        # the CLI's launches, not those of the checks after it
        totals_wide[dk] = {k: trained[k] + synth[k] for k in counters}
        print(f"fs2 recipe at dk {dk} ({' '.join(FS2_WIDE_OPTS[dk])}): K4 "
              f"launches {totals_wide[dk]} (training {trained}, synthesis "
              f"{synth})")
    # K4 at the adim 512 run's own shapes, in both types (these launches
    # count for nothing)
    _, d256_log, d256_model = wide[FS2_D256_DK]
    for dtype in (torch.float32, torch.bfloat16):
        _layers_k4(d256_model, [e["lengths"] for e in d256_log
                                if e["kind"] == "train"],
                   "fs2_d256", FS2_D256_DK, dtype)
    print(f"fs2 recipe at dk {', '.join(map(str, wide))}: "
          f"{time.perf_counter() - t_wide:.1f} s")
    # the resumed run against the straight one: the same batches, dropout
    # masks and weights at step 4, and every kernel's sums in a fixed
    # order, so the last step's and the evaluation's metrics agree bitwise
    if got != want:
        raise AssertionError(f"fs2 recipe: resumed run {got} against "
                             f"straight {want}")
    if spk_model.spk_embed_integration_type != "concat":
        raise AssertionError("aishell3.yaml did not build the concat "
                             "integration")
    # step 0, flash against dense, from the same weights, batch and masks
    flash0, dense0 = flash_log[0], dense_log[0]
    loss_err = abs(flash0["loss"] - dense0["loss"])
    if not loss_err <= FS2_LOSS_REL_TOL * abs(dense0["loss"]):
        raise AssertionError(f"fs2 recipe step 0 loss {flash0['loss']} "
                             f"(flash) against {dense0['loss']} (dense)")
    gq, gq_d = flash0["q_grad"], dense0["q_grad"]
    rel_l2 = ((gq - gq_d).norm() / gq_d.norm()).item()
    if not rel_l2 <= FS2_GRAD_REL_L2:
        raise AssertionError(f"fs2 recipe step 0 decoder q-weight gradient:"
                             f" relative L2 {rel_l2} > {FS2_GRAD_REL_L2}")
    print(f"fs2 recipe: resumed at iteration {first_steps} and ran steps "
          f"{first_steps}-{last_steps - 1} only; its last train and eval "
          f"metrics equal the straight run's bitwise; step 0 flash against "
          f"dense: loss {flash0['loss']:.7g} vs {dense0['loss']:.7g} "
          f"(|diff| {loss_err:.3g}, tol "
          f"{FS2_LOSS_REL_TOL * abs(dense0['loss']):.3g}), decoder q-weight "
          f"gradient relative L2 {rel_l2:.4g} (tol {FS2_GRAD_REL_L2:.4g}); "
          f"K4 launches over the three flash runs {totals}")
    for name in counters:
        records[f"{name}_dk{RECIPE_DK}"]["launches"] = totals[name]
        for dk, n in totals_wide.items():
            records[f"{name}_dk{dk}"]["launches"] = n[name]
    shutil.rmtree(out, ignore_errors=True)


def fs2_width_synthesis(out, zh, snapshot, dk):
    """The FastSpeech2 synthesis CLI (``synthesize_e2e.py``) on the dk
    ``dk`` run's ``snapshot``: its YAML is default.yaml with that run's
    ``--opts`` ('flash', ``FS2_WIDE_OPTS[dk]``), a PWG of seeded weights
    vocodes (K1), the first FS2_WIDE_LINES lines of TTW_CASES through the
    Chinese frontend's map ``zh``.  Checks each line's wav (finite, the
    frames' samples), K1's
    launches, the AM graph bitwise its eager program, and each line's mel
    against the same weights' acoustic program with 'dense' (eager) within
    FS2_INFER_REL_TOL of its range on the predicted frames.  Returns K4's
    launches in the CLI (K4a only: no gradient), read before those
    checks."""
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.models import PWGGenerator
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.recipes.fastspeech2 import \
        synthesize_e2e as fs2_e2e
    from parakeet_tpu_torch.training import Config, save_pytree
    counters = _k4_counters()
    before = {k: f.launches for k, f in counters.items()}
    opts = ["model.attn_impl", "flash", *FS2_RECIPE_ATTN_OPTS,
            *FS2_WIDE_OPTS[dk]]
    confs = {impl: out / f"fs2_d{dk}_{impl}.yaml" for impl in ("flash",
                                                                "dense")}
    for impl, path in confs.items():
        Config.from_yaml(FS2_RECIPE_CONF).merge_opts(
            opts[:1] + [impl] + opts[2:]).dump(path)
    pwg = PWGGenerator(**PWG_CONFIG)
    seeded_init_(pwg, torch.Generator().manual_seed(SEED + 25))
    save_pytree(out / "pwg.npz", flax_arrays(pwg))
    cases = [ln.split("|")[0] for ln in pathlib.Path(
        TTW_CASES).read_text(encoding="utf-8").splitlines()
             if ln and not ln.startswith("#")][:FS2_WIDE_LINES]
    (out / f"d{dk}.txt").write_text("".join(
        f"zh_{i:04d} {c}\n" for i, c in enumerate(cases)), encoding="utf-8")
    k1.fused_residual_stack.launches = 0
    got = fs2_e2e.main([
        "--fastspeech2-config", str(confs["flash"]),
        "--fastspeech2-checkpoint", str(snapshot), "--pwg-config",
        RECIPE_CONF, "--pwg-checkpoint", str(out / "pwg.npz"),
        "--phones-dict", str(zh["phones"]), "--text",
        str(out / f"d{dk}.txt"), "--min-duration", str(TTW_MIN_DURATION),
        "--output-dir", str(out / f"d{dk}_wavs")])
    k1_n = k1.fused_residual_stack.launches
    launches = {k: f.launches - before[k] for k, f in counters.items()}
    lines, hop = got["lines"], math.prod(PWG_CONFIG["upsample_scales"])
    if not (len(lines) == FS2_WIDE_LINES
            and k1_n == PWG_CONFIG["layers"] * FS2_WIDE_LINES
            and launches["K4a"] > 0 and launches["K4b"] == 0
            and launches["K4c"] == 0):
        raise AssertionError(f"fs2 synthesis at dk {dk}: "
                             f"{len(lines)} lines, K1 x {k1_n}, K4 "
                             f"{launches}")
    am, _ = fs2_e2e.build_acoustic_model(confs["dense"], snapshot,
                                         zh["phones"], None,
                                         torch.device("cuda"))
    dense = fs2_e2e.acoustic_program(am, 128, 1024, TTW_MIN_DURATION,
                                     torch.device("cuda"), graph=False)
    program = got["program"]
    errs = []
    for r in lines:
        if not (0 < r["frames"] <= 1024 and r["samples"] == r["frames"] * hop
                and np.isfinite(r["wav"]).all()):
            raise AssertionError(f"fs2 synthesis at dk {dk} "
                                 f"{r['utt_id']}: {r['frames']} frames, "
                                 f"{r['samples']} samples")
        program.load(r["ids"])
        eager, graph = program.eager(), program.program()
        if not all(torch.equal(a, b) for a, b in zip(graph, eager)):
            raise AssertionError(f"fs2 synthesis at dk {dk}: the "
                                 "AM graph is not its eager program")
        mel, n = dense(r["ids"])
        if int(n[0]) != r["frames"]:
            raise AssertionError(f"fs2 synthesis at dk {dk} "
                                 f"{r['utt_id']}: 'dense' predicts "
                                 f"{int(n[0])} frames, 'flash' "
                                 f"{r['frames']}")
        f = r["frames"]
        err, tol = _hold(f"fs2 synthesis at dk {dk} {r['utt_id']}"
                         " mel, flash against dense", eager[0][0, :f],
                         mel[0, :f], FS2_INFER_REL_TOL)
        errs.append(err / tol * FS2_INFER_REL_TOL)
    print(f"fs2 synthesis at dk {dk} (synthesize_e2e.py on the "
          f"snapshot, PWG of seeded weights): " + "; ".join(
              f"{r['utt_id']} {len(r['ids'])} phones, {r['frames']} frames: "
              f"AM {1e3 * r['am_s']:.2f} ms, vocoder "
              f"{1e3 * r['vocoder_s']:.2f} ms" for r in lines)
          + f"; capture {got['capture_s']:.2f} s; K1 x {k1_n}; K4 "
          f"{launches}; the graph bitwise its eager program; mel against "
          f"'dense' within {max(errs):.3g} of its range (tol "
          f"{FS2_INFER_REL_TOL:.3g})")
    return launches


def phase_fs2_bench():
    """The FastSpeech2 training bench at its defaults, 'dense' and 'flash'
    in turns (dense, flash, flash, dense)."""
    from parakeet_tpu_torch.benchmarks import train_fastspeech2
    ips = {"dense": [], "flash": []}
    for impl in ("dense", "flash", "flash", "dense"):
        rec = train_fastspeech2.main(["--attn-impl", impl, "--iters",
                                      str(FS2_BENCH_ITERS)])
        if not rec["value"] > 0:
            raise AssertionError(f"fs2 bench {impl}: {rec}")
        ips[impl].append(rec["value"])
    print(f"fs2 bench: fastspeech2_train_avg_ips at its defaults (batch 32, "
          f"96 tokens, 640 frames, 4 heads), {FS2_BENCH_ITERS} iterations, "
          f"sequences/s: dense {ips['dense']}, flash {ips['flash']}; flash / "
          f"dense {sum(ips['flash']) / sum(ips['dense']):.4f}")


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


def family_recipe(tag, train, factory, argv, out, epochs, resume_epochs,
                  mel_key, opts=(), limit_key="max_epoch",
                  steps_per_unit=FAMILY_STEPS_PER_EPOCH):
    """A family's recipe through its CLI (``train.main``, on the card):
    ``epochs`` epochs from an empty directory, a second run to
    ``resume_epochs`` that must resume from the newest snapshot and run
    only the steps after it, and a straight ``resume_epochs`` run whose
    last train and eval metrics must equal the resumed run's bitwise;
    every loss and metric finite.  ``factory`` names the train-step
    factory the module calls, wrapped here to time each step; ``mel_key``
    is the batch's mel, whose (B, frames) each step prints.  ``opts`` go
    to ``--opts`` before ``limit_key`` (``max_iteration`` counts
    ``epochs`` in iterations, ``steps_per_unit`` 1)."""
    log = []
    make = getattr(train, factory)

    def timed(model, *args, **kwargs):
        fn = make(model, *args, **kwargs)

        def step(state, batch):
            i = state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(state, batch)
            loss = float(result[1]["loss"])
            log.append((i, 1e3 * (time.perf_counter() - t0), loss,
                        tuple(batch[mel_key].shape)))
            return result
        return step

    spe = steps_per_unit
    runs = {}
    setattr(train, factory, timed)
    try:
        for name, directory, n, want in (
                ("first", "resumed", epochs, range(epochs * spe)),
                ("resumed", "resumed", resume_epochs,
                 range(epochs * spe, resume_epochs * spe)),
                ("straight", "straight", resume_epochs,
                 range(resume_epochs * spe))):
            log.clear()
            trainer = train.main(argv + ["--output-dir",
                                         str(out / directory), "--opts",
                                         *opts, limit_key, str(n)])
            steps = [i for i, *_ in log]
            obs = {k: float(v) for k, v in trainer.observation.items()}
            if steps != list(want):
                raise AssertionError(f"{tag} recipe {name} run took steps "
                                     f"{steps}, not {list(want)}")
            if ("eval/loss" not in obs or not all(
                    math.isfinite(v) for v in obs.values())
                    or not all(math.isfinite(e[2]) for e in log)):
                raise AssertionError(f"{tag} recipe {name}: metrics {obs}")
            print(f"{tag} recipe {name} run: steps {steps}, batch x length "
                  "and ms a step (host clock, synchronised) " + ", ".join(
                      f"{'x'.join(map(str, e[3][:2]))} {e[1]:.1f}"
                      for e in log)
                  + "; " + ", ".join(f"{k} {v:.6g}" for k, v in obs.items()))
            runs[name] = obs
    finally:
        setattr(train, factory, make)
    if runs["resumed"] != runs["straight"]:
        raise AssertionError(f"{tag} recipe: resumed run {runs['resumed']} "
                             f"against straight {runs['straight']}")
    print(f"{tag} recipe: resumed at iteration {epochs * spe} and ran steps "
          f"{epochs * spe}-{resume_epochs * spe - 1} only; its last train "
          "and eval metrics equal the straight run's bitwise")


def family_program(family, iters=FAMILY_ITERS, warmup=FAMILY_ITERS,
                   frames=None):
    """``benchmarks/e2e_family_rtf.py``'s leg of ``family`` (bf16; its
    1,000 frames or ``frames``): one CUDA graph whose wav equals the eager
    program's bitwise and whose replay holds K1 30 times; then K1 against
    its plain version at the program's shape.  Returns K1's record with
    its launches over the bench's run (the eager calls and the
    capture)."""
    from parakeet_tpu_torch.benchmarks import e2e_family_rtf
    from parakeet_tpu_torch.ops.kernels.pwg_stack import \
        fused_residual_stack
    fused_residual_stack.launches = 0
    (rec,) = e2e_family_rtf.main(
        ["--families", family, "--iters", str(iters), "--warmup",
         str(warmup)] + ([] if frames is None else ["--frames", str(frames)]))
    launches = fused_residual_stack.launches
    layers = PWG_CONFIG["layers"]
    n_k1 = _named(rec["replay_kernels"], K1_KERNEL)
    if not (rec["value"] > 0 and rec["graph_matches_eager"]
            and n_k1 == layers and rec["launches"] == {"K1": layers}
            and launches > 0 and launches % layers == 0
            and rec["samples"] == FAMILY_K1_T[family]):
        raise AssertionError(f"{family} program: {rec}")
    print(f"{family} program ({rec['dtype']}, {rec['samples']} samples, "
          f"{rec['audio_seconds']:.4f} s of audio; "
          f"{rec['device']}, {rec['power_limit']}): "
          f"{family}_pwgan_e2e_rtf {rec['value']:.6f}, graph "
          f"{rec['graph_ms']:.3f} ms a call, eager {rec['eager_ms']:.3f} "
          f"ms, busy {rec['replay_busy_ms']:.3f} ms in a replay of "
          f"{rec['replay_kernels_total']} kernels; the graph's wav bitwise "
          f"the eager program's, K1 x {n_k1} in a replay; frames "
          f"{rec['frame_lengths']}; K1 launches over the bench {launches}; "
          f"capture {rec['capture_s']:.2f} s, {rec['graph_pool_mib']:.1f} "
          "MiB reserved")
    record = k1_check(torch.Generator().manual_seed(SEED + 1), 1,
                      FAMILY_K1_T[family],
                      name=f"pwg_residual_stack_{family}")
    record["launches"] = launches
    return record


def phase_transformer_tts():
    """Phase 15: the TransformerTTS recipe (its CLI, resume against
    straight), its r=1 and r=2 synthesis programs as one CUDA graph each,
    then the decode loops of ``ar_decode``.  Returns K1's records of the
    two programs."""
    import shutil
    from parakeet_tpu_torch.recipes.transformer_tts import train
    from parakeet_tpu_torch.recipes.transformer_tts.dump import \
        write_synthetic_dump
    out = pathlib.Path("build") / "chip_smoke_transformer_tts"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 16,
                              splits=TT_RECIPE_SPLITS,
                              frames=TT_RECIPE_FRAMES,
                              phones=TT_RECIPE_PHONES, n_mels=ODIM)
    family_recipe("transformer_tts", train,
                  "make_transformer_tts_train_step",
                  ["--config", TT_RECIPE_CONF, "--train-metadata",
                   str(md["train"]), "--dev-metadata", str(md["dev"]),
                   "--phones-dict", str(md["phones"])], out,
                  TT_RECIPE_EPOCHS, TT_RECIPE_RESUME_EPOCHS, "speech")
    shutil.rmtree(out, ignore_errors=True)
    records = [family_program(f"transformer_tts_r{r}", TT_FAMILY_ITERS, 0,
                              TT_FAMILY_FRAMES) for r in (1, 2)]
    phase_ar_decode()
    return records


def phase_ar_decode():
    """``benchmarks/ar_decode.py`` in float32 at ``AR_DECODE_STEPS``
    steps, one call timed: Tacotron2 and TransformerTTS r=1, then r=2;
    each graph bitwise its eager program."""
    from parakeet_tpu_torch.benchmarks import ar_decode
    iters = ["--iters", str(AR_DECODE_ITERS), "--warmup", "0", "--steps",
             str(AR_DECODE_STEPS)]
    recs = ar_decode.main(iters)
    recs += ar_decode.main(iters + ["--models", "transformer_tts",
                                    "--reduction-factor", "2"])
    if not all(r["value"] > 0 and r["graph_matches_eager"] for r in recs):
        raise AssertionError(f"ar_decode: {recs}")
    print(f"ar_decode ({recs[0]['device']}, {recs[0]['power_limit']}; "
          f"{recs[0]['dtype']}, {recs[0]['steps']} steps, graphs bitwise "
          "eager): " + "; ".join(
              f"{r['metric']} r={r['reduction_factor']}"
              + f" {r['value']:.5f} ms (eager {r['eager_ms'] / r['steps']:.5f};"
              f" {r['achieved_tflops']:.4f} TFLOP/s, MFU {r['mfu_pct']:.4f}%,"
              f" capture {r['capture_s']:.2f} s,"
              f" {r['graph_pool_mib']:.1f} MiB)" for r in recs))


def phase_waveflow():
    """Phase 16: the WaveFlow recipe (its CLI, resume against straight,
    iteration-based), the sampler of ``waveflow_rtf`` in float32 and bf16
    as one CUDA graph each, the bf16 sampler's float32 sums, then
    ``train_am``'s TransformerTTS and WaveFlow legs."""
    import shutil
    from parakeet_tpu_torch.benchmarks import waveflow_rtf
    from parakeet_tpu_torch.recipes.waveflow import train
    from parakeet_tpu_torch.recipes.waveflow.dump import write_synthetic_dump
    out = pathlib.Path("build") / "chip_smoke_waveflow"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 17,
                              splits=WF_RECIPE_SPLITS,
                              frames=WF_RECIPE_FRAMES, n_mels=ODIM)
    family_recipe("waveflow", train, "make_waveflow_train_step",
                  ["--config", WF_RECIPE_CONF, "--train-metadata",
                   str(md["train"]), "--dev-metadata", str(md["dev"])],
                  out, WF_RECIPE_ITERS, WF_RECIPE_RESUME_ITERS, "mel",
                  opts=WF_RECIPE_OPTS, limit_key="max_iteration",
                  steps_per_unit=1)
    shutil.rmtree(out, ignore_errors=True)
    device = torch.device("cuda")
    recs, wavs = {}, {}
    for dtype in ("float32", "bfloat16"):
        recs[dtype], wavs[dtype] = waveflow_rtf.run(dtype, device,
                                                    WAVEFLOW_ITERS)
        if not (recs[dtype]["value"] > 0
                and recs[dtype]["graph_matches_eager"]):
            raise AssertionError(f"waveflow_rtf {dtype}: {recs[dtype]}")
    err, rel = _hold_l2("waveflow bf16 sampler", wavs["bfloat16"],
                        wavs["float32"], WAVEFLOW_BF16_REL_L2)
    rec = recs["float32"]
    print(f"waveflow_rtf ({rec['device']}, {rec['power_limit']}; "
          f"{rec['frames']} frames, {rec['samples']} samples, "
          f"{rec['flops'] / 1e12:.4f} TFLOP a call; graphs bitwise eager): "
          + "; ".join(
              f"{d} waveflow_synthesis_rtf {r['value']:.6f}, graph "
              f"{r['graph_ms']:.3f} ms, eager {r['eager_ms']:.3f} ms, "
              f"{r['achieved_tflops']:.3f} TFLOP/s, MFU {r['mfu_pct']:.3f}%, "
              f"capture {r['capture_s']:.2f} s" for d, r in recs.items())
          + f"; bf16 against float32: max abs err {err:.4g}, relative L2 "
          f"{rel:.4g} (tol {WAVEFLOW_BF16_REL_L2:.4g})")
    waveflow_accumulation()
    phase_am_bench(["transformer_tts", "waveflow"])


def waveflow_accumulation():
    """The bf16 sampler's products (``models/waveflow.py::mm_f32``)
    accumulate and return float32 on the card: a width tap (waveflow_rtf's
    1 x 5,504 grid columns of 3 x 128 inputs against 256 outputs) and an
    output projection (128 inputs) against float64 products of the same
    bf16 values, within WAVEFLOW_ACCUM_REL of the range; beside it, what
    a bf16 result would give (not held).  The sampler's wav cannot show
    this at full width: a change of the float32 sums' order alone moves
    it as much as rounding each product to bf16 does."""
    from parakeet_tpu_torch.benchmarks import waveflow_rtf
    from parakeet_tpu_torch.models.waveflow import mm_f32
    cfg = waveflow_rtf.MODEL_CONFIG
    c = cfg["channels"]
    w = waveflow_rtf.FRAMES * math.prod(cfg["upsample_factors"]) \
        // cfg["n_group"]
    gen = torch.Generator().manual_seed(SEED + 18)
    held = []
    for name, k in (("tap", cfg["kernel_size"][0] * c),
                    ("output projection", c)):
        a = torch.randn((1, w, k), generator=gen).bfloat16().cuda()
        b = (torch.randn((k, 2 * c), generator=gen)
             / math.sqrt(k)).bfloat16().cuda()
        got = mm_f32(a, b)
        if got.dtype != torch.float32:
            raise AssertionError(f"mm_f32 {name}: {got.dtype}")
        ref = a.double() @ b.double()
        err, tol = _hold(f"mm_f32 {name}", got.double(), ref.float(),
                         WAVEFLOW_ACCUM_REL)
        rounded = (got.bfloat16().double() - ref).abs().max().item()
        held.append(f"{name} ({w} x {k} x {2 * c}) max abs err {err:.4g} "
                    f"(tol {tol:.4g}; a bf16 result {rounded:.4g})")
    print("waveflow bf16 sampler's products on the card against float64: "
          + "; ".join(held))


def phase_speedyspeech():
    """Phase 13: the SpeedySpeech recipe (its CLI, resume against
    straight), then its synthesis program as one CUDA graph."""
    import shutil
    from parakeet_tpu_torch.recipes.speedyspeech import train
    from parakeet_tpu_torch.recipes.speedyspeech.dump import \
        write_synthetic_dump
    out = pathlib.Path("build") / "chip_smoke_speedyspeech"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 14,
                              splits=SS_RECIPE_SPLITS,
                              frames=SS_RECIPE_FRAMES,
                              phones=SS_RECIPE_PHONES, n_mels=ODIM)
    family_recipe("speedyspeech", train, "make_speedyspeech_train_step",
                  ["--config", SS_RECIPE_CONF, "--train-metadata",
                   str(md["train"]), "--dev-metadata", str(md["dev"]),
                   "--phones-dict", str(md["phones"]), "--tones-dict",
                   str(md["tones"])], out, SS_RECIPE_EPOCHS,
                  SS_RECIPE_RESUME_EPOCHS, "feats")
    shutil.rmtree(out, ignore_errors=True)
    return family_program("speedyspeech")


def phase_tacotron2():
    """Phase 14: the Tacotron2 recipe (its CLI, resume against straight),
    its synthesis program (1,000 decoder steps) as one CUDA graph, then
    the per-family training bench."""
    import shutil
    from parakeet_tpu_torch.recipes.tacotron2 import train
    from parakeet_tpu_torch.recipes.tacotron2.dump import \
        write_synthetic_dump
    out = pathlib.Path("build") / "chip_smoke_tacotron2"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 15,
                              splits=T2_RECIPE_SPLITS,
                              frames=T2_RECIPE_FRAMES,
                              phones=T2_RECIPE_PHONES, n_mels=ODIM)
    family_recipe("tacotron2", train, "make_tacotron2_train_step",
                  ["--config", T2_RECIPE_CONF, "--train-metadata",
                   str(md["train"]), "--dev-metadata", str(md["dev"]),
                   "--phones-dict", str(md["phones"])], out,
                  T2_RECIPE_EPOCHS, T2_RECIPE_RESUME_EPOCHS, "speech")
    shutil.rmtree(out, ignore_errors=True)
    record = family_program("tacotron2")
    phase_am_bench(["tacotron2", "speedyspeech"])
    return record


def phase_am_bench(models):
    """The per-family training bench at the JAX bench's shapes, each of
    ``models`` with PyTorch's defaults."""
    from parakeet_tpu_torch.benchmarks import train_am
    recs = train_am.main(["--models", *models, "--iters",
                          str(AM_BENCH_ITERS), "--warmup",
                          str(AM_BENCH_WARMUP)])
    if not all(r["value"] > 0 for r in recs):
        raise AssertionError(f"train_am: {recs}")
    print(f"train_am ({recs[0]['device']}, {recs[0]['power_limit']}; B "
          f"32, 96 tokens, 640 frames; WaveFlow B 8 x 65 frames; "
          f"{AM_BENCH_ITERS} iterations): "
          + "; ".join(
              f"{r['metric']} "
              f"{'deterministic' if r['deterministic'] else 'default'} "
              f"{r['value']:.4f} ({r['ms_per_step']:.1f} ms a step)"
              for r in recs))


def phase_ge2e():
    """Phase 17: GE2E at the JAX bench's widths: one step on the card
    against the CPU's, the recipe's CLI on a seeded tree with a snapshot,
    its inference over the tree, then the bench."""
    import shutil
    from parakeet_tpu_torch.benchmarks import ge2e_train
    from parakeet_tpu_torch.benchmarks.common import card
    from parakeet_tpu_torch.recipes.ge2e import inference, train
    from parakeet_tpu_torch.recipes.ge2e.dump import write_synthetic_mels
    name, limit = card(torch.device("cuda"))
    ge2e_step_against_cpu(name, limit)
    out = pathlib.Path("build") / "chip_smoke_ge2e"
    shutil.rmtree(out, ignore_errors=True)
    root = write_synthetic_mels(out / "mels", seed=SEED + 20,
                                speakers=GE2E_SPEAKERS, utterances=GE2E_UTTS,
                                frames=GE2E_TREE_FRAMES, n_mels=GE2E_MELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train.main([
        "--data-root", str(root), "--output-dir", str(out / "exp"),
        "--max-iteration", str(GE2E_ITERS), "--save-interval",
        str(GE2E_ITERS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    snap = out / "exp" / "checkpoints" / f"snapshot_iter_{GE2E_ITERS}.npz"
    if not (state.step == GE2E_ITERS and snap.exists() and all(
            math.isfinite(float(v)) for v in metrics.values())):
        raise AssertionError(f"ge2e recipe: step {state.step}, {metrics}, "
                             f"snapshot {snap.exists()}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):     # a line a file
        embeds = inference.main(["--checkpoint", str(snap), "--input",
                                 str(root), "--output", str(out / "embeds")])
    infer_s = time.perf_counter() - t0
    norms = np.array([np.linalg.norm(e) for e in embeds.values()])
    first = sorted(root.rglob("*.npy"))[0]
    cpu_model = inference.load_encoder(snap, torch.device("cpu"),
                                       n_mels=GE2E_MELS)
    from parakeet_tpu_torch.models import embed_utterance
    err = float(np.abs(embed_utterance(cpu_model, np.load(first)) - embeds[
        str(first.relative_to(root))]).max())
    if not (len(embeds) == GE2E_SPEAKERS * GE2E_UTTS
            and np.allclose(norms, 1.0, atol=1e-5) and err <= 1e-5):
        raise AssertionError(f"ge2e inference: {len(embeds)} embeddings, "
                             f"norms {norms.min()}-{norms.max()}, against "
                             f"the CPU {err}")
    shutil.rmtree(out, ignore_errors=True)
    print(f"ge2e recipe ({name}, {limit}): {GE2E_ITERS} iterations of "
          f"{GE2E_SPEAKERS} x {GE2E_UTTS} x {GE2E_FRAMES} frames in "
          f"{train_s:.2f} s with the model's set-up, the snapshot and the "
          f"host's loading of {GE2E_SPEAKERS * GE2E_UTTS} mels a batch "
          f"(host clock); last loss {float(metrics['loss']):.6g}, accuracy "
          f"{float(metrics['accuracy']):.6g}; inference over the tree's "
          f"{len(embeds)} utterances in {infer_s:.2f} s "
          f"({1e3 * infer_s / len(embeds):.2f} ms an utterance with its "
          f"files), unit norms, the first against the CPU's {err:.3g} "
          "(tol 1e-5)")
    rec = ge2e_train.main(["--iters", str(GE2E_BENCH_ITERS)])
    if not rec["value"] > 0:
        raise AssertionError(f"ge2e_train: {rec}")
    print(f"ge2e_train ({rec['device']}, {rec['power_limit']}; "
          f"{rec['speakers']} x {rec['utts_per_speaker']} x {rec['frames']} "
          f"x {rec['n_mels']}, float32, {GE2E_BENCH_ITERS} iterations): "
          f"ge2e_train_avg_ips {rec['value']:.4f} utterances/s, "
          f"{rec['ms_per_step']:.3f} ms a step, "
          f"{rec['flops_per_step'] / 1e12:.4f} TFLOP a step, "
          f"{rec['achieved_tflops']:.4f} TFLOP/s, MFU "
          + ("not stated for this card" if rec["mfu_pct"] is None else
             f"{rec['mfu_pct']:.4f}% of the bf16 peak"))


def ge2e_step_against_cpu(name, limit):
    """One GE2E step at full width on the card and on the CPU from the same
    weights and batch: the losses, the gradients (after the (w, b)
    scaling) and the parameters after Adam, within the GE2E_* tolerances
    (see the constants)."""
    from parakeet_tpu_torch.models import (LSTMSpeakerEncoder,
                                           init_ge2e_train_state,
                                           make_ge2e_train_step)
    from parakeet_tpu_torch.nn.initializer import init_flax_defaults_
    from parakeet_tpu_torch.training import build_optimizer
    x = torch.from_numpy(np.random.default_rng(SEED + 19).standard_normal(
        (GE2E_SPEAKERS * GE2E_UTTS, GE2E_FRAMES, GE2E_MELS)).astype(
            np.float32))
    runs = {}
    for device in ("cpu", "cuda"):
        model = LSTMSpeakerEncoder(n_mels=GE2E_MELS)
        init_flax_defaults_(model, torch.Generator().manual_seed(SEED + 19))
        model.to(device)
        opt = build_optimizer(model.parameters(), "adam", GE2E_LR)
        step = make_ge2e_train_step(model, opt, GE2E_SPEAKERS)
        state = init_ge2e_train_state(model, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, {"utterances": x.to(device)})
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        runs[device] = (loss, 1e3 * (time.perf_counter() - t0), {
            n: (p.detach().cpu(), p.grad.detach().cpu())
            for n, p in model.named_parameters()})
    (cpu_loss, cpu_ms, cpu), (loss, ms, card_) = runs["cpu"], runs["cuda"]
    if not (math.isfinite(loss)
            and abs(loss - cpu_loss) <= GE2E_LOSS_RTOL * abs(cpu_loss)):
        raise AssertionError(f"ge2e step: loss {loss} on the card, "
                             f"{cpu_loss} on the CPU")
    worst_g = worst_p = 0.0
    for n, (p_cpu, g_cpu) in cpu.items():
        p, g = card_[n]
        if n == "similarity_bias":
            continue
        rel = ((g.double() - g_cpu.double()).norm()
               / max(g_cpu.double().norm().item(), 1e-30)).item()
        sure = g_cpu.abs() >= GE2E_SURE * g_cpu.abs().max()
        diff = (p - p_cpu).abs()
        err = diff[sure].max().item()
        if not (rel <= GE2E_GRAD_REL_L2 and err <= GE2E_MOVE_TOL * GE2E_LR):
            raise AssertionError(f"ge2e step {n}: gradient relative L2 "
                                 f"{rel}, parameter error {err}")
        worst_g, worst_p = max(worst_g, rel), max(worst_p, err)
    print(f"ge2e step ({name}, {limit}; {GE2E_SPEAKERS} x {GE2E_UTTS} x "
          f"{GE2E_FRAMES} x {GE2E_MELS}, 3 x 256 LSTM, float32, TF32 off): "
          f"loss {loss:.7g} on the card, {cpu_loss:.7g} on the CPU; worst "
          f"gradient relative L2 {worst_g:.3g} (tol {GE2E_GRAD_REL_L2}), "
          f"worst parameter error after Adam {worst_p:.3g} (tol "
          f"{GE2E_MOVE_TOL * GE2E_LR:.3g}; b not held); the "
          f"first step {ms:.1f} ms on the card (cuDNN's plans and the "
          f"allocator's first use included), {cpu_ms:.1f} ms on the CPU "
          "(host clock)")


def phase_voice_cloning():
    """Phase 18: voice cloning through the CLI at the YAMLs' widths with
    random weights (the reference embedded on the card and on the CPU, the
    Tacotron2 graph held bitwise to its eager program, timed parts and
    RTF), then the aishell3 recipe resumed against straight."""
    import shutil
    from parakeet_tpu_torch.audio import save_wav
    from parakeet_tpu_torch.audio.synthetic import formant_utterance
    from parakeet_tpu_torch.benchmarks.common import (WAVEFLOW_CONFIG, card,
                                                      seeded_waveflow)
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.frontend import Vocab, generate_lexicon
    from parakeet_tpu_torch.models import LSTMSpeakerEncoder
    from parakeet_tpu_torch.nn.initializer import init_flax_defaults_
    from parakeet_tpu_torch.recipes.tacotron2 import train as t2_train
    from parakeet_tpu_torch.recipes.tacotron2_aishell3 import voice_cloning
    from parakeet_tpu_torch.recipes.tacotron2_aishell3.dump import \
        write_synthetic_dump
    from parakeet_tpu_torch.training import Config, save_pytree
    name, limit = card(torch.device("cuda"))
    out = pathlib.Path("build") / "chip_smoke_voice_cloning"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gen = torch.Generator().manual_seed(SEED + 21)
    ge2e = LSTMSpeakerEncoder()
    init_flax_defaults_(ge2e, gen)
    save_pytree(out / "ge2e.npz", flax_arrays(ge2e))
    lexicon = generate_lexicon(with_tone=True, with_erhua=True)
    vocab = Vocab(sorted({p for v in lexicon.values() for p in v.split()}))
    (out / "phone_id_map.txt").write_text(
        "".join(f"{sym} {i}\n" for sym, i in vocab.stoi.items()))
    t2 = t2_train.build_model(Config.from_yaml(VC_RECIPE_CONF), len(vocab))
    save_pytree(out / "t2.npz", flax_arrays(t2))
    save_pytree(out / "wf.npz", flax_arrays(seeded_waveflow(WAVEFLOW_CONFIG,
                                                            gen)))
    (out / "sentences.txt").write_text("\n".join(VC_SENTENCES) + "\n")
    ref = formant_utterance(VC_REF_PHONES, sr=voice_cloning.REF_SR,
                            hop_length=160, seed=SEED + 22)["wav"]
    save_wav(out / "ref.wav", ref, voice_cloning.REF_SR)
    res = voice_cloning.main([
        "--config", VC_RECIPE_CONF, "--checkpoint", str(out / "t2.npz"),
        "--ge2e-checkpoint", str(out / "ge2e.npz"), "--ref-wav",
        str(out / "ref.wav"), "--phones-dict",
        str(out / "phone_id_map.txt"), "--text", str(out / "sentences.txt"),
        "--waveflow-config", WF_RECIPE_CONF, "--waveflow-checkpoint",
        str(out / "wf.npz"), "--output-dir", str(out / "cloned")])
    lines, fs = res["lines"], res["sample_rate"]
    cpu_emb = voice_cloning.embed_reference(out / "ref.wav", out / "ge2e.npz",
                                            torch.device("cpu"))
    emb_err = float(np.abs(res["embedding"] - cpu_emb).max())
    hop = math.prod(WAVEFLOW_CONFIG["upsample_factors"])
    from parakeet_tpu_torch.audio import load_wav
    for r in lines:
        wav, sr = load_wav(r["path"])
        if not (sr == fs and len(wav) == r["samples"] == r["frames"] * hop
                and np.isfinite(wav).all()):
            raise AssertionError(f"voice cloning {r}: {len(wav)} samples "
                                 f"at {sr}")
    if not (len(lines) == len(VC_SENTENCES) and emb_err <= 1e-5):
        raise AssertionError(f"voice cloning: {lines}, embedding against "
                             f"the CPU {emb_err}")
    speech = res["speech"]
    ids = voice_cloning.phone_ids(VC_SENTENCES[-1].split(maxsplit=1)[1],
                                  lexicon, vocab.stoi)
    speech.load(ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_mel, eager_len = speech.eager()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    graph_mel, graph_len = speech.program()
    if not (torch.equal(graph_mel, eager_mel)
            and torch.equal(graph_len, eager_len)):
        raise AssertionError("voice cloning: the Tacotron2 graph's mel is "
                             "not its eager program's")
    decode = sum(r["decode_s"] for r in lines)
    vocode = sum(r["vocoder_s"] for r in lines)
    total = res["embed_s"] + decode + vocode
    audio = sum(r["samples"] for r in lines) / fs
    shutil.rmtree(out, ignore_errors=True)
    print(f"voice cloning ({name}, {limit}; GE2E 3 x 256, Tacotron2 of "
          f"{VC_RECIPE_CONF} over {len(ids)} of 128 tokens x 1,000 steps "
          f"as one CUDA graph, WaveFlow of {WF_RECIPE_CONF} eager, float32, "
          "random weights; host clock, synchronised): embedding "
          f"{1e3 * res['embed_s']:.1f} ms (the encoder's load included; "
          f"against the CPU's {emb_err:.3g}, tol 1e-5), capture "
          f"{res['capture_s']:.2f} s, " + "; ".join(
              f"{r['utt_id']} {r['frames']} frames: decode "
              f"{1e3 * r['decode_s']:.1f} ms, vocoder "
              f"{1e3 * r['vocoder_s']:.1f} ms" for r in lines)
          + f"; total {total:.3f} s for {audio:.3f} s of audio, RTF "
          f"{total / audio:.4f}; the graph's mel and lengths bitwise the "
          f"eager program's ({1e3 * eager_s:.1f} ms eager)")
    md = write_synthetic_dump(out / "dump", seed=SEED + 23,
                              splits=VC_RECIPE_SPLITS,
                              frames=VC_RECIPE_FRAMES,
                              phones=VC_RECIPE_PHONES, n_mels=ODIM)
    family_recipe("tacotron2_aishell3", t2_train,
                  "make_tacotron2_train_step",
                  ["--config", VC_RECIPE_CONF, "--train-metadata",
                   str(md["train"]), "--dev-metadata", str(md["dev"]),
                   "--phones-dict", str(md["phones"])], out,
                  VC_RECIPE_EPOCHS, VC_RECIPE_RESUME_EPOCHS, "speech")
    shutil.rmtree(out, ignore_errors=True)


def _ttw_snapshots(out):
    """Random-weight snapshots of the phase-19 models at the recipe YAMLs'
    widths (FastSpeech2 and SpeedySpeech over the Chinese frontend's phone
    maps, TransformerTTS over the ARPABET map, PWG), written as the port
    writes them; returns their paths by name."""
    from parakeet_tpu_torch.benchmarks.common import seeded_init_
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.models import PWGGenerator
    from parakeet_tpu_torch.recipes.fastspeech2 import train as fs2_train
    from parakeet_tpu_torch.recipes.speedyspeech import train as ss_train
    from parakeet_tpu_torch.recipes.synthesis import write_id_maps
    from parakeet_tpu_torch.recipes.transformer_tts import train as tt_train
    from parakeet_tpu_torch.training import Config, save_pytree
    paths = {"zh": write_id_maps(out / "zh", "zh"),
             "en": write_id_maps(out / "en", "en")}

    def count(path):
        return len(path.read_text().splitlines())

    gen = torch.Generator().manual_seed(SEED + 24)
    fs2 = fs2_train.build_model(Config.from_yaml(FS2_RECIPE_CONF),
                                count(paths["zh"]["phones"]), ODIM)
    ss = ss_train.build_model(Config.from_yaml(SS_RECIPE_CONF),
                              count(paths["zh"]["tone_phones"]),
                              count(paths["zh"]["tones"]))
    tt = tt_train.build_model(Config.from_yaml(TT_RECIPE_CONF),
                              count(paths["en"]["phones"]), ODIM)
    with torch.no_grad():
        for head in (fs2.duration_predictor.stack.linear,
                     ss.duration_predictor.fc):
            head.weight.mul_(DURATION_SPREAD)
        # FastSpeech2 predicts log(d + 1), SpeedySpeech log d
        fs2.duration_predictor.stack.linear.bias.fill_(DURATION_BIAS)
        ss.duration_predictor.fc.bias.fill_(math.log(4.0))
    pwg = PWGGenerator(**PWG_CONFIG)
    seeded_init_(pwg, gen)
    for name, model in (("fs2", fs2), ("ss", ss), ("tt", tt), ("pwg", pwg)):
        paths[name] = out / f"{name}.npz"
        save_pytree(paths[name], flax_arrays(model))
    return paths


def phase_text_to_wav():
    """Phase 19: text in, a waveform out through the port's CLIs (the
    FastSpeech2, SpeedySpeech and TransformerTTS ``synthesize_e2e``
    twins and the serving twin) at the recipe YAMLs' widths, random
    weights; K1 30 times a vocoded line, the FastSpeech2 CLI's wavs with
    K1 against those with its plain version, its AM graph against its
    eager program, the serving twin's graphs against its eager engine bit
    for bit.  Returns K1's record, its launches over the three CLIs' K1
    runs."""
    import copy
    import shutil
    from parakeet_tpu_torch.benchmarks.common import card
    from parakeet_tpu_torch.frontend import zh_frontend
    from parakeet_tpu_torch.models import parallel_wavegan
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.recipes.fastspeech2 import serve
    from parakeet_tpu_torch.recipes.fastspeech2 import \
        synthesize_e2e as fs2_e2e
    from parakeet_tpu_torch.recipes.speedyspeech import \
        synthesize_e2e as ss_e2e
    from parakeet_tpu_torch.recipes.transformer_tts import \
        synthesize_e2e as tt_e2e
    name, limit = card(torch.device("cuda"))
    t_phase = time.perf_counter()
    out = pathlib.Path("build") / "chip_smoke_text_to_wav"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    snap = _ttw_snapshots(out)
    cases = [ln.split("|")[0] for ln in pathlib.Path(
        TTW_CASES).read_text(encoding="utf-8").splitlines()
             if ln and not ln.startswith("#")][:TTW_LINES]
    (out / "zh.txt").write_text("".join(
        f"zh_{i:04d} {s}\n" for i, s in enumerate(cases)), encoding="utf-8")
    (out / "zh1.txt").write_text(f"zh_0000 {cases[0]}\n", encoding="utf-8")
    (out / "en.txt").write_text(TTW_EN_SENTENCE + "\n")
    segmentation = ("jieba" if zh_frontend._HAS_JIEBA
                    else "without jieba: one word a sentence")
    fs2_argv = ["--fastspeech2-config", FS2_RECIPE_CONF,
                "--fastspeech2-checkpoint", str(snap["fs2"]),
                "--pwg-config", RECIPE_CONF, "--pwg-checkpoint",
                str(snap["pwg"]), "--phones-dict",
                str(snap["zh"]["phones"]), "--text", str(out / "zh.txt"),
                "--min-duration", str(TTW_MIN_DURATION)]
    # (a) FastSpeech2, with K1 and with its plain version
    k1.fused_residual_stack.launches = 0
    fs2 = fs2_e2e.main(fs2_argv + ["--output-dir", str(out / "fs2")])
    k1_fs2 = k1.fused_residual_stack.launches
    real = parallel_wavegan.fused_residual_stack
    # K1's plain version in the residual stack's place: it launches nothing
    parallel_wavegan.fused_residual_stack = \
        k1.fused_residual_stack_reference
    try:
        plain = fs2_e2e.main(fs2_argv + ["--output-dir",
                                         str(out / "fs2_plain")])
    finally:
        parallel_wavegan.fused_residual_stack = real
    lines, fs = fs2["lines"], fs2["sample_rate"]
    layers = PWG_CONFIG["layers"]
    hop = math.prod(PWG_CONFIG["upsample_scales"])
    errs = []
    for got, ref in zip(lines, plain["lines"]):
        err = float(np.abs(got["wav"] - ref["wav"]).max())
        tol = K1_REL_TOL * max(1.0, float(np.abs(ref["wav"]).max()))
        if not (got["ids"] == ref["ids"] and got["frames"] == ref["frames"]
                and 0 < got["frames"] <= 1024 and err <= tol
                and got["samples"] == got["frames"] * hop
                and np.isfinite(got["wav"]).all()):
            raise AssertionError(f"text to wav {got['utt_id']}: "
                                 f"{got['frames']} frames, K1 against "
                                 f"plain {err} > {tol}")
        errs.append(err / tol * K1_REL_TOL)
    if not (len(lines) == TTW_LINES and k1_fs2 == layers * TTW_LINES):
        raise AssertionError(f"text to wav: {len(lines)} lines, K1 "
                             f"launched {k1_fs2} times")
    program = fs2["program"]
    program.load(lines[-1]["ids"])
    eager = program.eager()
    graph = program.program()
    if not all(torch.equal(a, b) for a, b in zip(graph, eager)):
        raise AssertionError("text to wav: the FastSpeech2 graph is not "
                             "its eager program")
    print(f"text to wav, FastSpeech2 CLI ({name}, {limit}; "
          f"{FS2_RECIPE_CONF} and {RECIPE_CONF}, float32, random weights; "
          f"zh frontend {segmentation}; the AM one CUDA graph at (1, 128) x "
          f"1,024 frames, captured in {fs2['capture_s']:.2f} s; host "
          "clock, synchronised): " + "; ".join(
              f"{r['utt_id']} {len(r['ids'])} phones, {r['frames']} frames: "
              f"frontend {1e3 * r['frontend_s']:.3f} ms, AM "
              f"{1e3 * r['am_s']:.2f} ms, vocoder "
              f"{1e3 * r['vocoder_s']:.2f} ms, RTF "
              f"{(r['am_s'] + r['vocoder_s']) * fs / r['samples']:.4f}"
              for r in lines)
          + f"; K1 x {k1_fs2}; wavs against K1's plain version within "
          f"{max(errs):.3g} of their range (tol {K1_REL_TOL:.3g}); the "
          "graph bitwise its eager program")
    # (b) SpeedySpeech with tones, one line
    k1.fused_residual_stack.launches = 0
    ss = ss_e2e.main([
        "--config", SS_RECIPE_CONF, "--checkpoint", str(snap["ss"]),
        "--pwg-config", RECIPE_CONF, "--pwg-checkpoint", str(snap["pwg"]),
        "--phones-dict", str(snap["zh"]["tone_phones"]), "--tones-dict",
        str(snap["zh"]["tones"]), "--text", str(out / "zh1.txt"),
        "--output-dir", str(out / "ss")])
    k1_ss = k1.fused_residual_stack.launches
    (r,) = ss["lines"]
    if not (k1_ss == layers and r["frames"] > 0 and r["tones"]
            and np.isfinite(r["wav"]).all()):
        raise AssertionError(f"text to wav, SpeedySpeech: K1 x {k1_ss}, "
                             f"{r['frames']} frames")
    print(f"text to wav, SpeedySpeech CLI ({SS_RECIPE_CONF}, tones): "
          f"{r['utt_id']} {len(r['ids'])} phones, {r['frames']} frames: AM "
          f"{1e3 * r['am_s']:.2f} ms, vocoder (1,024 frames) "
          f"{1e3 * r['vocoder_s']:.2f} ms; capture {ss['capture_s']:.2f} s; "
          f"K1 x {k1_ss}")
    # (c) TransformerTTS, English, the decode one graph, PWG
    k1.fused_residual_stack.launches = 0
    tt = tt_e2e.main([
        "--config", TT_RECIPE_CONF, "--checkpoint", str(snap["tt"]),
        "--phones-dict", str(snap["en"]["phones"]), "--text",
        str(out / "en.txt"), "--pwg-config", RECIPE_CONF,
        "--pwg-checkpoint", str(snap["pwg"]), "--output-dir",
        str(out / "tt")])
    k1_tt = k1.fused_residual_stack.launches
    (r,) = tt["lines"]
    if not (k1_tt == layers and 0 < r["frames"] <= 500
            and r["samples"] == r["frames"] * hop
            and np.isfinite(r["wav"]).all()):
        raise AssertionError(f"text to wav, TransformerTTS: K1 x {k1_tt}, "
                             f"{r['frames']} frames")
    print(f"text to wav, TransformerTTS CLI ({TT_RECIPE_CONF}, en, 500 "
          f"steps): {len(r['ids'])} phones, {r['frames']} frames: decode "
          f"{1e3 * r['am_s']:.1f} ms, vocoder {1e3 * r['vocoder_s']:.2f} ms; "
          f"capture {tt['capture_s']:.2f} s; K1 x {k1_tt}")
    # (d) the serving twin, warmed up, against its own engine eagerly
    served = serve.main(fs2_argv + [
        "--batch-size", str(TTW_SERVE_BATCH), "--warmup", "--output-dir",
        str(out / "served")])
    engine = served["engine"]
    eager = copy.copy(engine)
    eager.graphs, eager._programs, eager._pool = False, {}, None
    want = eager.synthesize(served["requests"])
    for got, ref in zip(served["results"], want):
        if not (got.n_frames == ref.n_frames > 0
                and np.array_equal(got.wav, ref.wav)):
            raise AssertionError(f"serving twin {got.utt_id}: the graphs' "
                                 "wav is not the eager engine's")
    print(f"text to wav, serving twin (batch buckets up to "
          f"{TTW_SERVE_BATCH}, --warmup: {engine.compiled_programs} graphs "
          f"in {served['warmup_s']:.2f} s): {len(want)} requests "
          f"(frontend {1e3 * served['frontend_s']:.3f} ms), "
          f"{served['audio_s']:.3f} s of audio in {served['elapsed_s']:.4f} s,"
          f" {served['audio_s'] / served['elapsed_s']:.1f} audio-s/s; the "
          "graphs' wavs bitwise the eager engine's")
    shutil.rmtree(out, ignore_errors=True)
    longest = max(r["samples"] for r in lines)
    record = k1_check(torch.Generator().manual_seed(SEED + 1), 1, longest,
                      name="pwg_residual_stack_text_to_wav")
    record["launches"] = k1_fs2 + k1_ss + k1_tt
    print(f"text to wav: phase {time.perf_counter() - t_phase:.1f} s")
    return record


def _corpus(out):
    """Phase 20's corpus under ``out``: six formant utterances at 24 kHz
    (seeded) in wavs/ with durations.txt (speakers spk0 and spk1), and
    the same wavs as an LJSpeech tree in lj/."""
    from parakeet_tpu_torch.audio import save_wav
    from parakeet_tpu_torch.audio.synthetic import formant_utterance
    (out / "wavs").mkdir(parents=True)
    (out / "lj" / "wavs").mkdir(parents=True)
    lines, csv = [], []
    for i, phones in enumerate(CORPUS_PHONES):
        utt = formant_utterance(phones, sr=SAMPLE_RATE, hop_length=300,
                                seed=SEED + 30 + i)
        save_wav(out / "wavs" / f"utt{i:03d}.wav", utt["wav"], SAMPLE_RATE)
        save_wav(out / "lj" / "wavs" / f"LJ001-{i:04d}.wav", utt["wav"],
                 SAMPLE_RATE)
        lines.append(f"utt{i:03d}|spk{i % 2}|" + " ".join(
            f"{p} {d}" for p, d in zip(utt["phones"], utt["durations"])))
        csv.append(f"LJ001-{i:04d}|{CORPUS_LJ_TEXT[i].upper()}|"
                   f"{CORPUS_LJ_TEXT[i]}")
    (out / "durations.txt").write_text("\n".join(lines) + "\n")
    (out / "lj" / "metadata.csv").write_text("\n".join(csv) + "\n")


def _with_plain_k1(main, argv):
    """``main(argv)`` with K1's plain version in the residual stack's
    place (it launches nothing)."""
    from parakeet_tpu_torch.models import parallel_wavegan
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    real = parallel_wavegan.fused_residual_stack
    parallel_wavegan.fused_residual_stack = \
        k1.fused_residual_stack_reference
    try:
        return main(argv)
    finally:
        parallel_wavegan.fused_residual_stack = real


def _k1_against_plain(what, lines, plain_lines, hop):
    """Each line's wav against the plain version's within K1_REL_TOL of
    its range, the same frames, finite, frames x hop samples; returns the
    largest error as a share of the range."""
    worst = 0.0
    for got, ref in zip(lines, plain_lines):
        err = float(np.abs(got["wav"] - ref["wav"]).max())
        scale = max(1.0, float(np.abs(ref["wav"]).max()))
        if not (got["frames"] == ref["frames"] > 0
                and err <= K1_REL_TOL * scale
                and got["samples"] == got["frames"] * hop
                and np.isfinite(got["wav"]).all()):
            raise AssertionError(f"{what} {got.get('utt_id')}: "
                                 f"{got['frames']} frames, K1 against plain "
                                 f"{err} > {K1_REL_TOL * scale}")
        worst = max(worst, err / scale)
    if len(lines) != len(plain_lines) or not lines:
        raise AssertionError(f"{what}: {len(lines)} lines")
    return worst


def _corpus_snapshots(out, dumps):
    """Random-weight snapshots at the recipe YAMLs' widths over the dumps'
    maps: FastSpeech2 (durations as phase 19's), Tacotron2 and
    TransformerTTS (the LJSpeech dump's character map), PWG and WaveFlow;
    returns their paths by name."""
    from parakeet_tpu_torch.benchmarks.common import (WAVEFLOW_CONFIG,
                                                      seeded_init_,
                                                      seeded_waveflow)
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.models import PWGGenerator
    from parakeet_tpu_torch.recipes.fastspeech2 import train as fs2_train
    from parakeet_tpu_torch.recipes.tacotron2 import train as t2_train
    from parakeet_tpu_torch.recipes.transformer_tts import train as tt_train
    from parakeet_tpu_torch.training import Config, save_pytree

    def count(path):
        return len(path.read_text().splitlines())

    gen = torch.Generator().manual_seed(SEED + 40)
    fs2 = fs2_train.build_model(Config.from_yaml(FS2_RECIPE_CONF),
                                count(dumps["fs2"] / "phone_id_map.txt"),
                                ODIM)
    with torch.no_grad():
        fs2.duration_predictor.stack.linear.weight.mul_(DURATION_SPREAD)
        fs2.duration_predictor.stack.linear.bias.fill_(DURATION_BIAS)
    chars = count(dumps["lj"] / "phone_id_map.txt")
    pwg = PWGGenerator(**PWG_CONFIG)
    seeded_init_(pwg, gen)
    t2 = t2_train.build_model(Config.from_yaml(T2_RECIPE_CONF), chars)
    tt = tt_train.build_model(Config.from_yaml(TT_RECIPE_CONF), chars, ODIM)
    with torch.no_grad():           # decode every step: the stop logit low
        t2.cell.stop_proj.bias.fill_(CORPUS_STOP_BIAS)
        tt.prob_out.bias.fill_(CORPUS_STOP_BIAS)
    models = {"fs2": fs2, "pwg": pwg, "t2": t2, "tt": tt,
              "wf": seeded_waveflow(WAVEFLOW_CONFIG, gen)}
    paths = {}
    for name, model in models.items():
        paths[name] = out / f"{name}.npz"
        save_pytree(paths[name], flax_arrays(model))
    return paths


def phase_corpus():
    """Phase 20: the corpus legs around training through the port's CLIs
    at the recipe YAMLs' widths: preprocess and normalize, synthesis from
    the dumps (K1 30 times a PWG line, each PWG CLI's wavs against K1's
    plain version's), the decodes and WaveFlow, then FastSpeech2's export
    (K1's operator in the exported vocoder's graph) and inference.py (K1
    30 times a line through the exported program; the exported programs
    against the eager ones).  Returns K1's records for the synthesis CLIs
    and for the exported vocoder."""
    import shutil
    from parakeet_tpu_torch.benchmarks.common import WAVEFLOW_CONFIG, card
    from parakeet_tpu_torch.models import pwg_inference
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.recipes.fastspeech2 import inference as fs2_inf
    from parakeet_tpu_torch.recipes.fastspeech2 import normalize as fs2_norm
    from parakeet_tpu_torch.recipes.fastspeech2 import preprocess as fs2_pre
    from parakeet_tpu_torch.recipes.fastspeech2 import synthesize as fs2_syn
    from parakeet_tpu_torch.recipes.fastspeech2 import \
        synthesize_e2e as fs2_e2e
    from parakeet_tpu_torch.recipes.pwgan import normalize as pwg_norm
    from parakeet_tpu_torch.recipes.pwgan import preprocess as pwg_pre
    from parakeet_tpu_torch.recipes.pwgan import synthesize as pwg_syn
    from parakeet_tpu_torch.recipes.pwgan import \
        synthesize_from_wav as copy_syn
    from parakeet_tpu_torch.recipes.tacotron2 import normalize as t2_norm
    from parakeet_tpu_torch.recipes.tacotron2 import preprocess as t2_pre
    from parakeet_tpu_torch.recipes.tacotron2 import synthesize as t2_syn
    from parakeet_tpu_torch.recipes.transformer_tts import \
        synthesize as tt_syn
    from parakeet_tpu_torch.recipes.waveflow import synthesize as wf_syn
    name, limit = card(torch.device("cuda"))
    t_phase = time.perf_counter()
    out = (pathlib.Path("build") / "chip_smoke_corpus").resolve()
    shutil.rmtree(out, ignore_errors=True)
    _corpus(out)
    layers = PWG_CONFIG["layers"]
    hop = math.prod(PWG_CONFIG["upsample_scales"])
    # (a) preprocess and normalize, host code
    tic = time.perf_counter()
    dumps = {k: out / k for k in ("fs2", "pwg", "lj")}
    splits = ["--num-cpu", "1", "--dev-size", "1"]
    fs2_rows = fs2_pre.main([
        "--rootdir", str(out / "wavs"), "--duration-file",
        str(out / "durations.txt"), "--dumpdir", str(dumps["fs2"]),
        "--config", FS2_RECIPE_CONF, *splits, "--test-size", "2"])
    pwg_rows = pwg_pre.main([
        "--rootdir", str(out / "wavs"), "--dumpdir", str(dumps["pwg"]),
        "--config", RECIPE_CONF, "--dur-file", str(out / "durations.txt"),
        "--cut-sil", *splits])
    lj_rows = t2_pre.main([
        "--rootdir", str(out / "lj"), "--dumpdir", str(dumps["lj"]),
        "--config", T2_RECIPE_CONF, *splits, "--test-size", "1"])
    for split in ("train", "test"):
        extra = ["--compute-stats"] if split == "train" else []
        fs2_norm.main([
            "--metadata", str(dumps["fs2"] / f"metadata_{split}.jsonl"),
            "--dumpdir", str(dumps["fs2"] / "norm" / split),
            "--phones-dict", str(dumps["fs2"] / "phone_id_map.txt"),
            "--speaker-dict", str(dumps["fs2"] / "speaker_id_map.txt"),
            *extra])
        t2_norm.main([
            "--metadata", str(dumps["lj"] / f"metadata_{split}.jsonl"),
            "--dumpdir", str(dumps["lj"] / "norm" / split),
            "--phones-dict", str(dumps["lj"] / "phone_id_map.txt"), *extra])
    for split, extra in (("train", ["--compute-stats"]), ("dev", [])):
        pwg_norm.main([
            "--metadata", str(dumps["pwg"] / f"metadata_{split}.jsonl"),
            "--dumpdir", str(dumps["pwg"] / "norm" / split), "--stats",
            str(dumps["pwg"] / "feats_stats.npy"), *extra])
    prep_s = time.perf_counter() - tic
    if not (len(fs2_rows) == len(pwg_rows) == len(lj_rows)
            == len(CORPUS_PHONES)):
        raise AssertionError(f"corpus: {len(fs2_rows)}, {len(pwg_rows)}, "
                             f"{len(lj_rows)} utterances preprocessed")
    frames = [r["speech_lengths"] for r in fs2_rows]
    print(f"corpus ({name}, {limit}; {len(CORPUS_PHONES)} formant "
          f"utterances at {SAMPLE_RATE} Hz, {min(frames)}-{max(frames)} "
          f"frames): preprocess (FastSpeech2, PWGAN --cut-sil, Tacotron2's "
          f"characters) and normalize on the host in {prep_s:.2f} s, "
          f"{prep_s / (3 * len(CORPUS_PHONES)):.3f} s an utterance and CLI")
    snap = _corpus_snapshots(out, dumps)
    # (b) FastSpeech2 and PWG from the dumps, copy synthesis: K1 against
    # its plain version
    k1_syn = 0
    runs = [("fastspeech2/synthesize.py", fs2_syn.main, [
        "--fastspeech2-config", FS2_RECIPE_CONF, "--fastspeech2-checkpoint",
        str(snap["fs2"]), "--fastspeech2-stat",
        str(dumps["fs2"] / "norm" / "speech_stats.npy"), "--pwg-config",
        RECIPE_CONF, "--pwg-checkpoint", str(snap["pwg"]),
        "--test-metadata", str(dumps["fs2"] / "norm" / "test" /
                               "metadata.jsonl"), "--phones-dict",
        str(dumps["fs2"] / "phone_id_map.txt")]),
        ("pwgan/synthesize.py", pwg_syn.main, [
            "--config", RECIPE_CONF, "--checkpoint", str(snap["pwg"]),
            "--test-metadata", str(dumps["pwg"] / "norm" / "dev" /
                                   "metadata.jsonl")]),
        ("pwgan/synthesize_from_wav.py", copy_syn.main, [
            "--config", RECIPE_CONF, "--checkpoint", str(snap["pwg"]),
            "--stats", str(dumps["pwg"] / "feats_stats.npy"), "--input-wav",
            str(out / "wavs" / "utt005.wav")])]
    fs2_t = None
    for i, (what, main, argv) in enumerate(runs):
        k1.fused_residual_stack.launches = 0
        got = main(argv + ["--output-dir", str(out / f"syn{i}")])
        launches = k1.fused_residual_stack.launches
        plain = _with_plain_k1(main, argv + ["--output-dir",
                                             str(out / f"plain{i}")])
        worst = _k1_against_plain(what, got["lines"], plain["lines"], hop)
        if launches != layers * len(got["lines"]):
            raise AssertionError(f"{what}: K1 launched {launches} times for "
                                 f"{len(got['lines'])} lines")
        k1_syn += launches
        if fs2_t is None:
            fs2_t = max(r["samples"] for r in got["lines"])
        capture = (f", the AM graph captured in {got['capture_s']:.2f} s"
                   if "capture_s" in got else "")
        print(f"corpus, {what} ({FS2_RECIPE_CONF + ', ' if i == 0 else ''}"
              f"{RECIPE_CONF}, float32, random weights; "
              f"host clock, synchronised{capture}"
              + ("" if i == 0 else "; the mel padded to 1,024 frames")
              + "): " + "; ".join(
                  f"{r.get('utt_id', 'wav')} {r['frames']} frames, K1 at T="
                  f"{r['samples'] if i == 0 else 1024 * hop}: " + "".join(
                      f"{part} {1e3 * r[key]:.2f} ms, " for part, key in (
                          ("AM", "am_s"), ("mel", "mel_s")) if key in r)
                  + f"vocoder {1e3 * r['vocoder_s']:.2f} ms"
                  for r in got["lines"])
              + f"; K1 x {launches}; wavs against K1's plain version within "
              f"{worst:.3g} of their range (tol {K1_REL_TOL:.3g})")
    # (c) the decodes and WaveFlow, one utterance each
    test_md = str(dumps["lj"] / "norm" / "test" / "metadata.jsonl")
    stat = str(dumps["lj"] / "norm" / "speech_stats.npy")
    chars = str(dumps["lj"] / "phone_id_map.txt")
    t2 = t2_syn.main([
        "--config", T2_RECIPE_CONF, "--checkpoint", str(snap["t2"]),
        "--stat", stat, "--test-metadata", test_md, "--phones-dict", chars,
        "--waveflow-config", WF_RECIPE_CONF, "--waveflow-checkpoint",
        str(snap["wf"]), "--max-decoder-steps", str(CORPUS_STEPS),
        "--output-dir", str(out / "t2")])
    mels = out / "mels"
    mels.mkdir()
    np.save(mels / "utt000.npy", np.load(fs2_rows[0]["speech"]))
    wf = wf_syn.main([
        "--config", WF_RECIPE_CONF, "--checkpoint", str(snap["wf"]),
        "--input", str(mels), "--max-frames", str(CORPUS_WF_FRAMES),
        "--output", str(out / "wf")])
    k1.fused_residual_stack.launches = 0
    tt = tt_syn.main([
        "--config", TT_RECIPE_CONF, "--checkpoint", str(snap["tt"]),
        "--stat", stat, "--test-metadata", test_md, "--phones-dict", chars,
        "--pwg-config", RECIPE_CONF, "--pwg-checkpoint", str(snap["pwg"]),
        "--max-decoder-steps", str(CORPUS_STEPS), "--output-dir",
        str(out / "tt")])
    k1_tt = k1.fused_residual_stack.launches
    wf_hop = math.prod(WAVEFLOW_CONFIG["upsample_factors"])
    for what, res, want_hop in (("tacotron2", t2, wf_hop),
                                ("waveflow", wf, wf_hop),
                                ("transformer_tts", tt, hop)):
        (r,) = res["lines"]
        if not (0 < r["frames"] <= max(CORPUS_STEPS, CORPUS_WF_FRAMES)
                and r["samples"] == r["frames"] * want_hop
                and np.isfinite(r["wav"]).all()):
            raise AssertionError(f"corpus, {what}: {r['frames']} frames, "
                                 f"{r['samples']} samples")
    if k1_tt != layers:
        raise AssertionError(f"corpus, transformer_tts: K1 x {k1_tt}")
    k1_syn += k1_tt
    (r2,), (rw,), (rt,) = t2["lines"], wf["lines"], tt["lines"]
    print(f"corpus, decodes ({T2_RECIPE_CONF}, {TT_RECIPE_CONF}, "
          f"{WF_RECIPE_CONF}; {CORPUS_STEPS} steps; host clock, "
          f"synchronised): Tacotron2 {r2['frames']} frames, decode "
          f"{1e3 * r2['am_s']:.1f} ms (capture {t2['capture_s']:.2f} s), "
          f"WaveFlow eager {1e3 * r2['vocoder_s']:.1f} ms; waveflow/"
          f"synthesize.py {rw['frames']} frames, the sampler graph at "
          f"{CORPUS_WF_FRAMES} frames {1e3 * rw['vocoder_s']:.1f} ms "
          f"(capture {wf['capture_s']:.2f} s); TransformerTTS "
          f"{rt['frames']} frames, decode {1e3 * rt['am_s']:.1f} ms "
          f"(capture {tt['capture_s']:.2f} s), PWG "
          f"{1e3 * rt['vocoder_s']:.2f} ms, K1 x {k1_tt}")
    # (d) export on the card, then inference.py
    ttw = out / "ttw"
    ttw.mkdir()
    tsnap = _ttw_snapshots(ttw)
    cases = [ln.split("|")[0] for ln in pathlib.Path(
        TTW_CASES).read_text(encoding="utf-8").splitlines()
             if ln and not ln.startswith("#")][:CORPUS_EXPORT_LINES]
    (ttw / "zh.txt").write_text("".join(
        f"zh_{i:04d} {s}\n" for i, s in enumerate(cases)), encoding="utf-8")
    export = out / "export"
    e2e = fs2_e2e.main([
        "--fastspeech2-config", FS2_RECIPE_CONF, "--fastspeech2-checkpoint",
        str(tsnap["fs2"]), "--pwg-config", RECIPE_CONF, "--pwg-checkpoint",
        str(tsnap["pwg"]), "--phones-dict", str(tsnap["zh"]["phones"]),
        "--text", str(ttw / "zh.txt"), "--min-duration",
        str(TTW_MIN_DURATION), "--output-dir", str(out / "e2e"),
        "--export-dir", str(export)])
    ep = torch.export.load(export / "pwgan.pt2")
    ops = [n for n in ep.graph.nodes if n.op == "call_function"
           and n.target == torch.ops.parakeet_tpu_torch.pwg_residual_stack
           .default]
    if len(ops) != 1:
        raise AssertionError(f"export: the vocoder's graph holds K1's "
                             f"operator {len(ops)} times")
    k1.fused_residual_stack.launches = 0
    inf = fs2_inf.main([
        "--export-dir", str(export), "--phones-dict",
        str(tsnap["zh"]["phones"]), "--text", str(ttw / "zh.txt"),
        "--output-dir", str(out / "inference")])
    k1_exp = k1.fused_residual_stack.launches
    lines = inf["lines"]
    if not (len(lines) == CORPUS_EXPORT_LINES
            and k1_exp == layers * len(lines)
            and [(r["ids"], r["frames"]) for r in lines]
            == [(r["ids"], r["frames"]) for r in e2e["lines"]]
            and all(np.isfinite(r["wav"]).all() for r in lines)):
        raise AssertionError(f"inference: {len(lines)} lines, K1 x {k1_exp}")
    # the exported programs against the eager ones on the last line
    speech, program = inf["speech"], e2e["program"]
    speech.program.load(lines[-1]["ids"])
    exp_mel, exp_n = speech.program.eager()
    program.load(lines[-1]["ids"])
    mel, n = program.eager()
    am_err = float((exp_mel - mel).abs().max()) / max(
        1.0, float(mel.abs().max()))
    if not (torch.equal(exp_n, n) and am_err <= 1e-5):
        raise AssertionError(f"export: the acoustic program's mel {am_err} "
                             "of its range from the eager program's")
    voc = fs2_e2e.build_vocoder(RECIPE_CONF, tsnap["pwg"],
                                torch.device("cuda"))
    with torch.no_grad():
        exp_wav = speech.voc(exp_mel, speech.noise)
        wav = pwg_inference(voc, exp_mel, noise=speech.noise)
        voc_err = float((exp_wav - wav).abs().max()) / max(
            1.0, float(wav.abs().max()))
        if voc_err > 2 ** -8:
            raise AssertionError(f"export: the vocoder's wav {voc_err} of "
                                 "its range from the eager vocoder's")
        exp_ms = cuda_ms(lambda: speech.voc(exp_mel, speech.noise), 5)
        eager_ms = cuda_ms(lambda: pwg_inference(voc, exp_mel,
                                                 noise=speech.noise), 5)
    cap = speech.max_frames * speech.hop
    print(f"corpus, export ({name}, {limit}): fastspeech2.pt2 and pwgan.pt2 "
          f"through torch.export in {e2e['export_s']:.2f} s, the vocoder's "
          f"graph holding K1's operator once; inference.py (AM graph "
          f"captured in {inf['capture_s']:.2f} s): " + "; ".join(
              f"{r['utt_id']} {r['frames']} frames: AM {1e3 * r['am_s']:.2f} "
              f"ms, vocoder at T={cap} {1e3 * r['vocoder_s']:.2f} ms"
              for r in lines)
          + f"; K1 x {k1_exp}; the exported AM's mel "
          + ("bitwise" if am_err == 0 else f"within {am_err:.3g} of its "
             "range of") + " the eager program's, the exported vocoder's "
          "wav " + ("bitwise" if voc_err == 0 else f"within {voc_err:.3g} "
                    "of its range of") + " the eager vocoder's; exported "
          f"vocoder {exp_ms:.3f} ms, eager {eager_ms:.3f} ms (median, CUDA "
          "events)")
    shutil.rmtree(out, ignore_errors=True)
    gen = torch.Generator().manual_seed(SEED + 1)
    syn = k1_check(gen, 1, fs2_t, name="pwg_residual_stack_synthesize")
    syn["launches"] = k1_syn
    exported = k1_check(gen, 1, cap, name="pwg_residual_stack_exported")
    exported["launches"] = k1_exp
    print(f"corpus: phase {time.perf_counter() - t_phase:.1f} s")
    return syn, exported


def paddle_pwg_state(seed):
    """A Paddle PWGGenerator state dict at PWG_CONFIG's widths (aux ODIM)
    under the reference's names and layouts, drawn from ``seed`` at
    tools/golden/fixtures.py's scales."""
    from tools.golden.fixtures import _B
    b = _B(np.random.default_rng(seed))
    cr, cg, cs = (PWG_CONFIG[k] for k in ("residual_channels",
                                          "gate_channels", "skip_channels"))
    b.wn_conv("first_conv", (cr, 1, 1))
    b.wn_conv("upsample_net.conv_in",
              (ODIM, ODIM, 2 * PWG_CONFIG["aux_context_window"] + 1),
              bias=False)
    for i, scale in enumerate(PWG_CONFIG["upsample_scales"]):
        p = f"upsample_net.upsample.up_layers.{2 * i + 1}"
        b.wn_conv(p, (1, 1, 1, 2 * scale + 1), bias=False)
        b.state[f"{p}.weight_g"] = b.state[f"{p}.weight_g"].reshape(1)
    for i in range(PWG_CONFIG["layers"]):
        p = f"conv_layers.{i}"
        b.wn_conv(f"{p}.conv", (cg, cr, 3))
        b.wn_conv(f"{p}.conv1x1_aux", (cg, ODIM, 1), bias=False)
        b.wn_conv(f"{p}.conv1x1_skip", (cs, cg // 2, 1))
        b.wn_conv(f"{p}.conv1x1_out", (cr, cg // 2, 1))
    b.wn_conv("last_conv_layers.1", (cs, cs, 1))
    b.wn_conv("last_conv_layers.3", (1, cs, 1))
    return b.state


def paddle_disc_state(seed):
    """A Paddle PWGDiscriminator state dict at DISC_CONFIG's widths: the
    convs at the even indices of one Sequential."""
    from tools.golden.fixtures import _B
    b = _B(np.random.default_rng(seed))
    n, ch, cin = DISC_CONFIG["layers"], DISC_CONFIG["conv_channels"], 1
    for i in range(n - 1):
        b.wn_conv(f"conv_layers.{2 * i}", (ch, cin, 3))
        cin = ch
    b.wn_conv(f"conv_layers.{2 * (n - 1)}", (1, cin, 3))
    return b.state


def paddle_fs2_state(seed):
    """A Paddle FastSpeech2 state dict at FS2_CONFIG's widths (the
    predictors at the model's defaults, CONV_FS2_PITCH_LAYERS pitch
    layers), the duration head scaled as phase 3's AM so that phones last
    a few frames."""
    from tools.golden.fixtures import _B
    cfg = FS2_CONFIG
    adim, k = cfg["adim"], cfg["positionwise_conv_kernel_size"]
    b = _B(np.random.default_rng(seed))

    def stack(prefix, layers, units, alpha_idx):
        b.state[f"{prefix}.embed.{alpha_idx}.alpha"] = np.ones((1,),
                                                               np.float32)
        if alpha_idx == 1:
            b.embed(f"{prefix}.embed.0", IDIM, adim)
        for i in range(layers):
            lp = f"{prefix}.encoders.{i}"
            for nm in ("q", "k", "v", "out"):
                b.dense(f"{lp}.self_attn.linear_{nm}", adim, adim)
            b.ln(f"{lp}.norm1", adim)
            b.ln(f"{lp}.norm2", adim)
            b.conv(f"{lp}.feed_forward.w_1", units, adim, k)
            b.conv(f"{lp}.feed_forward.w_2", adim, units, k)
        b.ln(f"{prefix}.after_norm", adim)

    stack("encoder", cfg["elayers"], cfg["eunits"], 1)
    stack("decoder", cfg["dlayers"], cfg["dunits"], 0)
    for name, layers, chans in (
            ("duration_predictor", cfg["duration_predictor_layers"],
             cfg["duration_predictor_chans"]),
            ("pitch_predictor", CONV_FS2_PITCH_LAYERS, 384),
            ("energy_predictor", 2, 384)):
        cin = adim
        for i in range(layers):
            b.conv(f"{name}.conv.{i}.0", chans, cin, 3)
            b.ln(f"{name}.conv.{i}.2", chans)
            cin = chans
        b.dense(f"{name}.linear", chans, 1)
    b.state["duration_predictor.linear.weight"] *= DURATION_SPREAD
    b.state["duration_predictor.linear.bias"][:] = DURATION_BIAS
    b.conv("pitch_embed.0", adim, 1, 9)
    b.conv("energy_embed.0", adim, 1, 9)
    b.dense("feat_out", adim, ODIM)
    n, chans = cfg["postnet_layers"], cfg["postnet_chans"]
    for i in range(n):
        b.conv(f"postnet.postnet.{i}.0", ODIM if i == n - 1 else chans,
               ODIM if i == 0 else chans, cfg["postnet_filts"], bias=False)
        b.bn(f"postnet.postnet.{i}.1", ODIM if i == n - 1 else chans)
    return b.state


def _fs2_oracle_kw():
    return dict(odim=ODIM, heads=FS2_CONFIG["aheads"],
                elayers=FS2_CONFIG["elayers"], dlayers=FS2_CONFIG["dlayers"],
                predictor_layers=FS2_CONFIG["duration_predictor_layers"],
                pitch_predictor_layers=CONV_FS2_PITCH_LAYERS,
                energy_predictor_layers=2,
                postnet_layers=FS2_CONFIG["postnet_layers"])


def _hold_rows(what, got, ref, lens, rel_tol):
    """Max abs error of ``got`` against ``ref`` (numpy) over each row's
    first ``lens[b]`` steps, held to rel_tol of ref's range there."""
    err = max(float(np.abs(got[b, :n] - ref[b, :n]).max())
              for b, n in enumerate(lens))
    scale = max(float(np.abs(ref[b, :n]).max()) for b, n in enumerate(lens))
    if not (np.isfinite(got).all() and err <= rel_tol * scale):
        raise AssertionError(f"{what}: max abs err {err} > "
                             f"{rel_tol * scale}")
    return err / scale


def _rel_l2_flat(got, want):
    """Relative L2 of the flat trees ``got`` against ``want`` (the same
    keys)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"gradient keys differ: "
                             f"{sorted(set(got) ^ set(want))}")
    g = np.concatenate([np.asarray(got[k], np.float64).ravel()
                        for k in sorted(want)])
    w = np.concatenate([np.asarray(want[k], np.float64).reshape(
        np.shape(got[k])).ravel() for k in sorted(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _converted_fs2(out, name, limit):
    """The FastSpeech2 dict through the port's CLI, teacher-forced and as
    the AM graph against the float64 oracle."""
    from parakeet_tpu_torch.bridge import load_checkpoint_params
    from parakeet_tpu_torch.models import FastSpeech2
    from parakeet_tpu_torch.recipes.fastspeech2.synthesize_e2e import \
        acoustic_program
    from parakeet_tpu_torch.tools import convert_fastspeech2_checkpoint
    from parakeet_tpu_torch.training import Config, inference_model_kwargs
    from tools.golden.fastspeech2 import golden_fastspeech2_forward
    state = paddle_fs2_state(SEED + 61)
    np.savez(out / "fs2_paddle.npz", **state)
    path = convert_fastspeech2_checkpoint.main([
        "--input", str(out / "fs2_paddle.npz"), "--config", FS2_RECIPE_CONF,
        "--output", str(out / "fs2.npz")])
    am = FastSpeech2(idim=IDIM, odim=ODIM, **inference_model_kwargs(
        Config.from_yaml(FS2_RECIPE_CONF).model),
        pitch_predictor_layers=CONV_FS2_PITCH_LAYERS)
    load_checkpoint_params(am, path)
    am = am.cuda().eval().requires_grad_(False)
    rng = np.random.default_rng(SEED + 62)
    ilens = np.asarray(CONV_FS2_LENGTHS)
    tmax = int(ilens.max())
    text = rng.integers(1, IDIM, (len(ilens), tmax))
    keep = np.arange(tmax)[None] < ilens[:, None]
    text = text * keep
    dur = rng.integers(2, 8, text.shape) * keep
    olens = dur.sum(1)
    pitch = rng.standard_normal((*text.shape, 1)).astype(np.float32)
    energy = rng.standard_normal((*text.shape, 1)).astype(np.float32)
    kw = _fs2_oracle_kw()

    def cuda(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).cuda()

    with torch.no_grad():
        got = am(cuda(text), cuda(ilens), torch.zeros(
            (len(ilens), int(olens.max()), ODIM), device="cuda"),
            cuda(olens), cuda(dur), cuda(pitch), cuda(energy),
            deterministic=True)
    gold = golden_fastspeech2_forward(state, text, ilens, dur, pitch,
                                      energy, **kw)
    held = {k: _hold_rows(f"converted FastSpeech2 {k}",
                          got[k].float().cpu().numpy(), gold[k], lens,
                          CONV_FS2_REL_TOL)
            for k, lens in (("before_outs", olens), ("after_outs", olens),
                            ("d_outs", ilens), ("p_outs", ilens),
                            ("e_outs", ilens))}
    # the AM graph on the first line; the oracle with its durations and
    # the oracle's own pitch and energy
    n = int(ilens[0])
    ids = text[0, :n].tolist()
    prog = acoustic_program(am, n, CONV_FS2_MAX_FRAMES, 0,
                            torch.device("cuda"))
    mel, frames = prog(ids)
    with torch.no_grad():
        eager = am.inference(cuda(text[:1, :n]), cuda(ilens[:1]),
                             max_frames=CONV_FS2_MAX_FRAMES)
    frames = int(frames[0])
    d_port = eager["d_outs"][0].long().cpu().numpy()
    if not (torch.equal(mel[0, :frames], eager["after_outs"][0, :frames])
            and frames == int(d_port.sum()) <= CONV_FS2_MAX_FRAMES):
        raise AssertionError(f"AM graph: {frames} frames, durations "
                             f"{d_port.sum()}, or not its eager program")
    first = golden_fastspeech2_forward(
        state, text[:1, :n], ilens[:1], d_port[None], np.zeros((1, n, 1)),
        np.zeros((1, n, 1)), **kw)
    d_gold = np.clip(np.round(np.exp(first["d_outs"][0]) - 1.0), 0, None)
    near = np.abs(np.exp(first["d_outs"][0]) - 1.0 - np.floor(
        np.exp(first["d_outs"][0]) - 1.0) - 0.5) < 1e-3
    if not np.all((d_gold == d_port) | near):
        raise AssertionError(f"AM graph durations {d_port} against the "
                             f"oracle's {d_gold}")
    gold_inf = golden_fastspeech2_forward(
        state, text[:1, :n], ilens[:1], d_port[None], first["p_outs"],
        first["e_outs"], **kw)
    # the program decodes to its capacity, so the decoder's feed-forward
    # convolutions (two a layer) and the Postnet read, at the last frames,
    # the frames past the utterance, where the reference's read zeros:
    # hold the frames outside their reach
    edge = (FS2_CONFIG["dlayers"]
            * (FS2_CONFIG["positionwise_conv_kernel_size"] - 1)
            + FS2_CONFIG["postnet_layers"]
            * (FS2_CONFIG["postnet_filts"] - 1) // 2)
    got_mel = mel[:, :frames].float().cpu().numpy()
    with torch.no_grad():
        exact = am.inference(cuda(text[:1, :n]), cuda(ilens[:1]),
                             max_frames=frames, durations=cuda(d_port[None]))
    held["inference_at_length"] = _hold_rows(
        "converted FastSpeech2 inference at the utterance's length",
        exact["after_outs"].float().cpu().numpy(), gold_inf["after_outs"],
        [frames], CONV_FS2_REL_TOL)
    held["graph_after_outs"] = _hold_rows(
        "converted FastSpeech2 AM graph", got_mel, gold_inf["after_outs"],
        [frames - edge], CONV_FS2_GRAPH_REL_TOL)
    edge_err = float(np.abs(got_mel[0, frames - edge:]
                            - gold_inf["after_outs"][0, frames - edge:])
                     .max())
    print(f"checkpoints ({name}, {limit}): FastSpeech2 converted by "
          f"convert_fastspeech2_checkpoint at default.yaml's widths "
          f"({len(state)} Paddle tensors); teacher-forced on "
          f"{ilens.tolist()} phones and the AM graph on {n} ({frames} frames) "
          f"against the float64 oracle, max abs err over each output's "
          f"range (tol {CONV_FS2_REL_TOL:.3g}, the graph's "
          f"{CONV_FS2_GRAPH_REL_TOL:.3g}): " + ", ".join(
              f"{k} {v:.3g}" for k, v in held.items())
          + f"; the graph's last {edge} frames (within reach of the frames "
          f"past the utterance, not held) max abs err {edge_err:.4g}")


def _gan_grads(g, d, noise, mel, wav):
    """(generator loss, discriminator loss, the generator's gradients of
    the whole loss, the discriminator's, the generator's through the
    spectral-convergence and adversarial terms) of the GAN step's two
    objectives, the discriminator live, as flat flax trees."""
    from parakeet_tpu_torch.bridge import flax_grads
    from parakeet_tpu_torch.models.pwg_updater import (
        discriminator_objective, generator_objective)
    from parakeet_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
    g.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    loss, _ = generator_objective(g, d, noise, mel, wav,
                                  lambda_adv=LAMBDA_ADV, disc_on=True,
                                  stft_kw=STFT_LOSS)
    loss.backward()
    with torch.no_grad():
        fake = g(noise, mel, deterministic=False)
    d_loss, _ = discriminator_objective(d, wav, fake)
    d_loss.backward()
    full_g, full_d = flax_grads(g), flax_grads(d)
    g.zero_grad(set_to_none=True)
    d.requires_grad_(False)
    fake = g(noise, mel, deterministic=False)
    sc, _ = multi_resolution_stft_loss(fake[..., 0], wav, **STFT_LOSS)
    adv = torch.mean(torch.square(d(fake).float() - 1.0))
    (sc + LAMBDA_ADV * adv).backward()
    d.requires_grad_(True)
    return loss.item(), d_loss.item(), full_g, full_d, flax_grads(g)


def _oracle_gan_grads(gen_state, disc_state, noise, mel, wav):
    """The float64 oracle's counterparts of ``_gan_grads`` on the CPU,
    through the port's converters onto the same keys."""
    from parakeet_tpu_torch.utils import convert as tc
    from tools.golden.common import grads_of, make_grad_state
    from tools.golden.pwg import (golden_mrstft_loss, golden_pwg_discriminator,
                                  golden_pwg_forward_t, golden_pwg_gan_grads)
    cfg = dict(layers=PWG_CONFIG["layers"], stacks=PWG_CONFIG["stacks"],
               upsample_scales=PWG_CONFIG["upsample_scales"],
               aux_context_window=PWG_CONFIG["aux_context_window"])
    noise_ncl, mel_ncl = noise.transpose(0, 2, 1), mel.transpose(0, 2, 1)
    metrics, gen_g, disc_g = golden_pwg_gan_grads(
        gen_state, disc_state, noise_ncl, mel_ncl, wav, gen_cfg=cfg,
        disc_layers=DISC_CONFIG["layers"], lambda_adv=LAMBDA_ADV,
        **STFT_LOSS)
    gs = make_grad_state(gen_state)
    fake = golden_pwg_forward_t(gs, noise_ncl, mel_ncl, **cfg)
    sc, _ = golden_mrstft_loss(fake[:, 0], torch.as_tensor(
        wav, dtype=torch.float64), **STFT_LOSS)
    adv = torch.mean(torch.square(golden_pwg_discriminator(
        disc_state, fake, layers=DISC_CONFIG["layers"]) - 1.0))
    (sc + LAMBDA_ADV * adv).backward()

    def gen_tree(grads):
        return tc.checkpoint_arrays(tc.convert_pwg_generator(
            grads, layers=PWG_CONFIG["layers"],
            upsample_scales=PWG_CONFIG["upsample_scales"]))
    return (metrics["generator_loss"], metrics["discriminator_loss"],
            gen_tree(gen_g), tc.checkpoint_arrays(
                tc.convert_pwg_discriminator(
                    disc_g, layers=DISC_CONFIG["layers"])),
            gen_tree(grads_of(gs)))


def _plain_k2():
    """A context in which the residual stack's training route runs K2a's
    and K2b's plain versions (they launch nothing)."""
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2

    def plain_backward(*args, need_weights=True, **kwargs):
        out = k2.group_backward_reference(*args, **kwargs)
        return out if need_weights else out[:2] + (None, None, None)

    @contextlib.contextmanager
    def swapped():
        real = k2.fused_group_forward_save, k2.fused_group_backward
        k2.fused_group_forward_save = k1.group_forward_reference
        k2.fused_group_backward = plain_backward
        try:
            yield
        finally:
            k2.fused_group_forward_save, k2.fused_group_backward = real
    return swapped()


def _converted_gan(paths, dtype):
    """The recipe's generator and discriminator (its YAML's impls) with
    the converted weights, on the card, computing in ``dtype``."""
    from parakeet_tpu_torch.bridge import load_checkpoint_params
    from parakeet_tpu_torch.models import PWGDiscriminator, PWGGenerator
    from parakeet_tpu_torch.training import Config, resolve_model_kwargs
    cfg = Config.from_yaml(RECIPE_CONF)
    dt = {"dtype": dtype}
    g = PWGGenerator(**resolve_model_kwargs({**cfg.generator_params, **dt}))
    d = PWGDiscriminator(**resolve_model_kwargs(
        {**cfg.discriminator_params, **dt}))
    load_checkpoint_params(g, paths["gen"])
    load_checkpoint_params(d, paths["disc"])
    return g.cuda(), d.cuda()


def _gan_step(g, d, seed):
    from parakeet_tpu_torch.models import (init_pwg_train_state,
                                           make_pwg_train_step)
    from parakeet_tpu_torch.training import build_optimizer, seed_everything
    state = init_pwg_train_state(
        g, d, build_optimizer(g.parameters(), "adam", GEN_LR),
        build_optimizer(d.parameters(), "adam", DISC_LR),
        seed_everything(seed, device="cuda"))
    step = make_pwg_train_step(g, d, lambda_adv=LAMBDA_ADV,
                               discriminator_train_start_steps=0,
                               **STFT_LOSS)
    return step, state


def _disc_update_fn(d, wav, fake):
    from parakeet_tpu_torch.models.pwg_updater import discriminator_objective

    def run():
        d.zero_grad(set_to_none=True)
        loss, _ = discriminator_objective(d, wav, fake)
        loss.backward()
    return run


def phase_checkpoints(records):
    """Phase 21: Paddle checkpoints through the port's converters at the
    recipe YAMLs' widths, and the mixed-precision GAN step.  ``records``:
    phase 5's K2a/K2b/K3a/K3b records, whose numbers the GAN steps'
    records carry (same shapes) with this phase's launches.  Returns the
    phase's kernel records."""
    import shutil
    from parakeet_tpu_torch.benchmarks import train_pwgan
    from parakeet_tpu_torch.benchmarks.common import card
    from parakeet_tpu_torch.models import parallel_wavegan as tpwg
    from parakeet_tpu_torch.models import PWGDiscriminator
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.recipes.pwgan import synthesize as pwg_syn
    from parakeet_tpu_torch.recipes.pwgan import train
    from parakeet_tpu_torch.recipes.pwgan.dump import write_synthetic_dump
    from parakeet_tpu_torch.tools import convert_pwg_checkpoint
    from parakeet_tpu_torch.training import save_pytree
    from parakeet_tpu_torch.utils import convert as tc
    from tools.golden.pwg import golden_pwg_forward_t
    t_phase = time.perf_counter()
    name, limit = card(torch.device("cuda"))
    out = (pathlib.Path("build") / "chip_smoke_checkpoints").resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    layers = PWG_CONFIG["layers"]
    hop = math.prod(PWG_CONFIG["upsample_scales"])
    w = PWG_CONFIG["aux_context_window"]
    # (a) the generator through the CLI (a whole GAN's dump: the scope is
    # stripped), the discriminator through the converter
    gen_state = paddle_pwg_state(SEED + 60)
    disc_state = paddle_disc_state(SEED + 63)
    np.savez(out / "gan_paddle.npz",
             **{f"generator.{k}": v for k, v in gen_state.items()},
             **{f"discriminator.{k}": v for k, v in disc_state.items()})
    paths = {"gen": convert_pwg_checkpoint.main([
        "--input", str(out / "gan_paddle.npz"), "--config", RECIPE_CONF,
        "--output", str(out / "pwg.npz")]), "disc": out / "disc.npz"}
    save_pytree(paths["disc"], tc.checkpoint_arrays(
        tc.convert_pwg_discriminator(disc_state,
                                     layers=DISC_CONFIG["layers"])))
    # (b) vocode through pwgan/synthesize.py (K1) against the oracle
    rng = np.random.default_rng(SEED + 64)
    mel = rng.standard_normal((CONV_FRAMES, ODIM)).astype(np.float32)
    np.save(out / "conv0.npy", mel)
    (out / "metadata.jsonl").write_text(json.dumps(
        {"utt_id": "conv0", "feats": str(out / "conv0.npy")}) + "\n")
    k1.fused_residual_stack.launches = 0
    syn = pwg_syn.main(["--config", RECIPE_CONF, "--checkpoint",
                        str(paths["gen"]), "--test-metadata",
                        str(out / "metadata.jsonl"), "--output-dir",
                        str(out / "wavs"), "--max-frames", str(CONV_FRAMES)])
    k1_launches = k1.fused_residual_stack.launches
    if k1_launches != layers:
        raise AssertionError(f"converted vocoder: K1 launched {k1_launches} "
                             f"times, not {layers}")
    voc = syn["vocoder"]
    gold_state = {k: torch.as_tensor(v, dtype=torch.float64).cuda()
                  for k, v in gen_state.items()}
    mel_pad = tpwg.edge_pad(torch.from_numpy(mel)[None].cuda(), w)
    gold = golden_pwg_forward_t(
        gold_state, voc.noise.double().transpose(1, 2),
        mel_pad.double().transpose(1, 2), layers=layers,
        stacks=PWG_CONFIG["stacks"],
        upsample_scales=PWG_CONFIG["upsample_scales"],
        aux_context_window=w)[0, 0]
    wav = torch.from_numpy(syn["lines"][0]["wav"]).cuda()
    wav_err, wav_tol = _hold("converted vocoder against the oracle", wav,
                             gold, CONV_WAV_REL_TOL)
    k1_rec = k1_check(torch.Generator().manual_seed(SEED + 65), 1,
                      CONV_FRAMES * hop, name="pwg_residual_stack_converted",
                      stack=voc.voc.stack)
    k1_rec["launches"] = k1_launches
    print(f"checkpoints ({name}, {limit}): a whole GAN's Paddle dump "
          f"({len(gen_state)} + {len(disc_state)} tensors) converted by "
          f"convert_pwg_checkpoint (generator. scope stripped); "
          f"pwgan/synthesize.py on {CONV_FRAMES} frames: K1 {k1_launches} "
          f"launches, vocoder {1e3 * syn['lines'][0]['vocoder_s']:.2f} ms; "
          f"wav against the float64 oracle on the card: max abs err "
          f"{wav_err:.4g} (tol {wav_tol:.4g}, range "
          f"{gold.abs().max().item():.4g})")
    _converted_fs2(out, name, limit)
    # (c) the GAN step's gradients on a clip against the oracle, float32
    # and mixed bf16, each also with K2a/K2b's plain versions
    rng = np.random.default_rng(SEED + 66)
    t_clip = CONV_CLIP_FRAMES * hop
    noise = rng.standard_normal((1, t_clip, 1)).astype(np.float32)
    cmel = rng.standard_normal((1, CONV_CLIP_FRAMES + 2 * w, ODIM)).astype(
        np.float32)
    cwav = (0.3 * rng.standard_normal((1, t_clip))).astype(np.float32)
    gold = _oracle_gan_grads(gen_state, disc_state, noise, cmel, cwav)
    inputs = [torch.from_numpy(a).cuda() for a in (noise, cmel, cwav)]
    nets = {dt: _converted_gan(paths, dt) for dt in ("float32", "bfloat16")}
    for dt, (g, d) in nets.items():
        got = _gan_grads(g, d, *inputs)
        with _plain_k2():
            plain = _gan_grads(g, d, *inputs)
        loss_err = [abs(got[i] - gold[i]) / abs(gold[i]) for i in (0, 1)]
        rel = [_rel_l2_flat(got[i], gold[i]) for i in (2, 3, 4)]
        plain_rel = _rel_l2_flat(got[4], plain[4])
        print(f"checkpoints ({name}, {limit}): GAN step {dt} on a "
              f"{CONV_CLIP_FRAMES}-frame clip against golden_pwg_gan_grads "
              f"(float64): losses relative {loss_err[0]:.3g}, "
              f"{loss_err[1]:.3g} (tol {CONV_LOSS_REL_TOL:.3g}); relative "
              f"L2 of the generator's gradient {rel[0]:.4g} (tol "
              f"{CONV_FULL_GRAD_REL_L2:.3g}), of its spectral + "
              f"adversarial part {rel[2]:.4g} (tol "
              f"{CONV_GEN_GRAD_REL_L2:.3g}) and of the discriminator's "
              f"{rel[1]:.4g} (tol {CONV_GRAD_REL_L2:.3g}); K2a/K2b against "
              f"their plain versions on that part {plain_rel:.4g} (tol "
              f"{K2_REL_TOL:.3g})")
        if not (max(loss_err) <= CONV_LOSS_REL_TOL
                and rel[0] <= CONV_FULL_GRAD_REL_L2
                and rel[1] <= CONV_GRAD_REL_L2
                and rel[2] <= CONV_GEN_GRAD_REL_L2
                and plain_rel <= K2_REL_TOL):
            raise AssertionError(
                f"GAN gradients {dt}: losses {loss_err}, relative L2 "
                f"{rel}, kernels against plain K2 {plain_rel}")
    # (d) the GAN step at the recipe's shape, float32 and bf16 in turns
    gen = torch.Generator().manual_seed(SEED + 67)
    frames = TRAIN_T // hop + 2 * w
    batch = {"wav": (0.3 * torch.randn((TRAIN_B, TRAIN_T),
                                       generator=gen)).cuda(),
             "mel": torch.randn((TRAIN_B, frames, ODIM),
                                generator=gen).cuda()}
    counters = _train_counters()
    steps, launches = {}, {}
    for dt, (g, d) in nets.items():
        steps[dt] = _gan_step(g, d, SEED + 68)
        step, state = steps[dt]
        step(state, batch)                                 # warm-up
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches[dt] = {k: f.launches for k, f in counters.items()}
        bad = {k: float(v) for k, v in metrics.items()
               if not math.isfinite(float(v))}
        fused = d.supported and (d.impl == "fused" or getattr(torch, dt)
                                 in tpwg.FUSED_AUTO_DTYPES)
        want = expected_launches(True)
        if not fused:
            want.update(K3a=0, K3b=0)
        if bad or launches[dt] != want:
            raise AssertionError(f"GAN step {dt}: metrics {bad}, launches "
                                 f"{launches[dt]}, expected {want}")

    def timed(dt):
        step, state = steps[dt]

        def run():
            for _ in range(CONV_STEP_ITERS):
                step(state, batch)
        return run
    ms = {dt: [] for dt in nets}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed(dt)()
        torch.cuda.synchronize()
        ms[dt].append(1e3 * (time.perf_counter() - t0) / CONV_STEP_ITERS)
    print(f"checkpoints ({name}, {limit}): GAN step of the converted "
          f"networks at B={TRAIN_B}, T={TRAIN_T}, the discriminator live, "
          f"in turns (float32, bf16, bf16, float32; {CONV_STEP_ITERS} "
          f"chained steps each, host clock): float32 "
          f"{ms['float32'][0]:.2f}, {ms['float32'][1]:.2f} ms; bf16 "
          f"{ms['bfloat16'][0]:.2f}, {ms['bfloat16'][1]:.2f} ms a step; "
          f"launches a step {launches}")
    # (e) the discriminator's update at bf16: K3a/K3b against the eager
    # loop, in turns (the evidence for 'auto' under bf16)
    g, d = nets["bfloat16"]
    with torch.no_grad():
        fake = g(torch.randn((TRAIN_B, TRAIN_T, 1), generator=gen).cuda(),
                 batch["mel"])
    disc = {impl: PWGDiscriminator(impl=impl, dtype=torch.bfloat16,
                                   **DISC_CONFIG).cuda()
            for impl in ("eager", "fused")}
    for m in disc.values():
        m.load_state_dict(d.state_dict())
    eager_a, fused_a, fused_b, eager_b = (
        cuda_ms(_disc_update_fn(disc[i], batch["wav"], fake), CONV_DISC_REPS)
        for i in ("eager", "fused", "fused", "eager"))
    disc32 = PWGDiscriminator(impl="fused", **DISC_CONFIG).cuda()
    disc32.load_state_dict(d.state_dict())
    fused32 = cuda_ms(_disc_update_fn(disc32, batch["wav"], fake.float()),
                      CONV_DISC_REPS)
    print(f"checkpoints ({name}, {limit}): the discriminator's update "
          f"(real and fake, forward and backward) at bf16, B={TRAIN_B}, "
          f"T={TRAIN_T}, in turns: eager {eager_a:.3f}, K3a/K3b "
          f"{fused_a:.3f}, K3a/K3b {fused_b:.3f}, eager {eager_b:.3f} ms "
          f"(median of {CONV_DISC_REPS}, CUDA events; K3a/K3b at float32 "
          f"{fused32:.3f}); 'auto' at bf16 "
          f"runs " + ("K3a/K3b" if torch.bfloat16 in tpwg.FUSED_AUTO_DTYPES
                      else "the eager loop"))
    # (f) the training bench, float32 and bf16 in turns
    ips = {"float32": [], "bfloat16": []}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        rec = train_pwgan.main(["--batch-sizes", str(TRAIN_B), "--iters",
                                str(CONV_BENCH_ITERS), "--dtype", dt])
        ips[dt].append(rec[0]["value"])
    print(f"checkpoints ({name}, {limit}): benchmarks/train_pwgan.py at "
          f"batch {TRAIN_B}, in turns: pwgan_train_avg_ips float32 "
          f"{ips['float32'][0]:.3f}, {ips['float32'][1]:.3f}; bf16 "
          f"{ips['bfloat16'][0]:.3f}, {ips['bfloat16'][1]:.3f} "
          f"sequences/s")
    # (g) the recipe's CLI with the YAML's bf16 --opts
    md = write_synthetic_dump(out / "dump", seed=SEED + 69,
                              splits=RECIPE_SPLITS, frames=RECIPE_FRAMES,
                              n_mels=ODIM, n_shift=hop)
    for f in counters.values():
        f.launches = 0
    tic = time.perf_counter()
    trainer = train.main([
        "--config", RECIPE_CONF, "--train-metadata", str(md["train"]),
        "--dev-metadata", str(md["dev"]), "--output-dir", str(out / "exp"),
        "--opts", *CONV_BF16_OPTS, "updater.discriminator_train_start_steps",
        str(RECIPE_DISC_START), "save_interval_steps", str(RECIPE_INTERVAL),
        "eval_interval_steps", str(RECIPE_INTERVAL), "train_max_steps",
        str(CONV_RECIPE_STEPS)])
    recipe_s = time.perf_counter() - tic
    obs = {k: float(v) for k, v in trainer.observation.items()}
    modules = trainer.updater.train_state.modules
    totals = {k: f.launches for k, f in counters.items()}
    if not (all(math.isfinite(v) for v in obs.values())
            and "eval/generator_loss" in obs
            and modules["generator"].dtype == torch.bfloat16
            and modules["discriminator"].dtype == torch.bfloat16
            and totals["K2a"] > 0 and totals["K2b"] > 0):
        raise AssertionError(f"bf16 recipe run: {obs}, launches {totals}")
    print(f"checkpoints ({name}, {limit}): the PWGAN recipe's CLI with "
          f"{' '.join(CONV_BF16_OPTS)}: {CONV_RECIPE_STEPS} steps and "
          f"evaluations in {recipe_s:.2f} s, launches {totals}; " + ", ".join(
              f"{k} {v:.5g}" for k, v in obs.items()))
    out_records = [k1_rec]
    for dt in nets:
        for key in ("K2a", "K2b", "K3a", "K3b"):
            if launches[dt][key]:
                out_records.append(dict(
                    records[key], name=f"{records[key]['name']}_converted_"
                    f"{dt}", launches=launches[dt][key]))
    print(f"checkpoints: phase {time.perf_counter() - t_phase:.1f} s")
    return out_records


def _layers_fs2_run(out, md, counters):
    """Phase 22 (a): the FastSpeech2 recipe's CLI with LAYERS_OPTS and the
    profiler's window; returns (trainer, each step's loss, each step's
    batch lengths on the host, the initial parameters, the K4 launches of
    the run, seconds)."""
    from parakeet_tpu_torch.recipes.fastspeech2 import train
    losses, lengths, initial = [], [], {}
    make = train.make_fs2_train_step

    def recording(model, *args, **kwargs):
        initial.update({k: p.detach().clone()
                        for k, p in model.named_parameters()})
        step = make(model, *args, **kwargs)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            lengths.append({k: batch[k].cpu() for k in (
                "text", "text_lengths", "speech", "speech_lengths")})
            return state, metrics
        return wrapped

    lo, hi = LAYERS_WINDOW
    train.make_fs2_train_step = recording
    for f in counters.values():
        f.launches = 0
    tic = time.perf_counter()
    try:
        trainer = train.main([
            "--config", FS2_RECIPE_CONF, "--train-metadata",
            str(md["train"]), "--dev-metadata", str(md["dev"]),
            "--output-dir", str(out / "exp"), "--phones-dict",
            str(md["phones"]), "--profiler-options",
            f"batch_range=[{lo},{hi}];profile_path={out / 'profile'}",
            "--opts", *LAYERS_OPTS, "batch_size", str(LAYERS_BATCH),
            "max_epoch", "1"])
    finally:
        train.make_fs2_train_step = make
    seconds = time.perf_counter() - tic
    totals = {k: f.launches for k, f in counters.items()}
    return trainer, losses, lengths, initial, totals, seconds


def _layers_tensorboard(logdir, steps):
    """What the recipe's TensorBoard writer left: a line."""
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        return "tensorboardX absent: the recipe trained without its writer"
    files = sorted(logdir.glob("events.out.tfevents.*"))
    if not files or files[0].stat().st_size == 0:
        raise AssertionError(f"no TensorBoard event file in {logdir}")
    try:
        from tensorboard.backend.event_processing.event_accumulator \
            import EventAccumulator
    except ImportError:
        return f"event file {files[0].name} ({files[0].stat().st_size} B)"
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    got = [e.step for e in acc.Scalars("train/loss")]
    if got != list(range(1, steps + 1)):
        raise AssertionError(f"TensorBoard train/loss at steps {got}")
    return f"event file holds train/loss at steps {got}"


def _card_and_cpu(make, seed):
    """(card module, CPU module) with the same weights from ``seed``."""
    cpu = make()
    from parakeet_tpu_torch.nn.initializer import init_flax_defaults_
    init_flax_defaults_(cpu, torch.Generator().manual_seed(seed))
    card_mod = make()
    card_mod.load_state_dict(cpu.state_dict())
    return card_mod.cuda(), cpu


def _layers_k4(model, lengths, tag="layers", dk=RECIPE_DK,
               dtype=torch.float32):
    """Phase 22 (b): K4a, K4b and K4c on the recipe run's own shapes, its
    train batch with the most frames: the encoder's self-attention over
    its phones and the decoder's over its frames (``_k4_case``, in
    ``dtype``, fresh inputs); returns their records (named
    ``*_dk<dk>_<tag>``), the two shapes' times summed and the launches
    still 0."""
    batch = max(lengths, key=lambda x: x["speech"].shape[1])
    r = model.reduction_factor
    frames = (batch["speech_lengths"] - batch["speech_lengths"] % r) // r
    runs = [(model.encoder, batch["text"].shape[1], batch["text_lengths"]),
            (model.decoder, batch["speech"].shape[1] // r, frames)]
    gen = torch.Generator().manual_seed(SEED + 77)
    cases, shapes = [], []
    for stack, t, n in runs:
        attn = stack.layer_0.self_attn
        heads = attn.n_heads
        kv_valid = (torch.arange(t)[None] < n[:, None]).to(torch.int32)
        cases.append(_k4_case(gen, torch.ones_like(kv_valid).cuda(),
                              kv_valid.cuda(), heads,
                              attn.d_model // heads, dtype))
        shapes.append((len(n), t, heads, attn.d_model // heads))
    if shapes[0][3] != dk or shapes[1][3] != dk:
        raise AssertionError(f"{tag} recipe: attention shapes {shapes}, "
                             f"expected dk {dk}")
    return _k4_records(cases, f"_dk{dk}_{tag}", dtype, dk), shapes


def phase_layers():
    """Phase 22: the remaining layers and training observability at the
    recipe YAMLs' widths.  Returns the K4 records of the recipe's shapes
    with the recipe run's launches."""
    import shutil
    from parakeet_tpu_torch.benchmarks.common import (TRANSFORMER_TTS_CONFIG,
                                                      card)
    from parakeet_tpu_torch.models import TransformerTTS, init_transformer_tts_
    from parakeet_tpu_torch.nn import Conv1dCell, LightweightConvolution
    from parakeet_tpu_torch.ops.length_regulator import gaussian_upsample
    from parakeet_tpu_torch.recipes.fastspeech2 import train
    from parakeet_tpu_torch.recipes.fastspeech2.dump import \
        write_synthetic_dump
    from parakeet_tpu_torch.tools import op_table
    from parakeet_tpu_torch.training import Config, build_optimizer
    from parakeet_tpu_torch.training.updater import to_device_batch
    from parakeet_tpu_torch.utils import timeline
    from parakeet_tpu_torch.utils.graphs import CapturedProgram
    t_phase = time.perf_counter()
    name, limit = card(torch.device("cuda"))
    tag = f"layers ({name}, {limit})"
    out = (pathlib.Path("build") / "chip_smoke_layers").resolve()
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out / "dump", seed=SEED + 70,
                              splits=LAYERS_SPLITS, frames=LAYERS_FRAMES,
                              phones=LAYERS_PHONES, n_mels=ODIM)
    # (a) the recipe's CLI: concat_after, flash, lamb, the profiler window
    counters = _k4_counters()
    trainer, losses, lengths, initial, totals, recipe_s = _layers_fs2_run(
        out, md, counters)
    steps = LAYERS_SPLITS["train"] // LAYERS_BATCH
    model = trainer.updater.train_state.modules["model"]
    inner = trainer.updater.train_state.optimizers["model"].inner
    obs = {k: float(v) for k, v in trainer.observation.items()}
    if not (len(losses) == steps and all(map(math.isfinite, losses))
            and all(map(math.isfinite, obs.values())) and "eval/loss" in obs
            and type(inner).__name__ == "Lamb"
            and model.decoder.layer_0.concat_after):
        raise AssertionError(f"layers recipe: losses {losses}, {obs}, "
                             f"{type(inner).__name__}")
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach().cpu(), initial[k].cpu())]
    if still:
        raise AssertionError(f"layers recipe: parameters that did not move: "
                             f"{still}")
    layers = FS2_CONFIG["elayers"] + FS2_CONFIG["dlayers"]
    eval_batches = -(-LAYERS_SPLITS["dev"] // LAYERS_BATCH)
    want = {"K4a": layers * (steps + eval_batches), "K4b": layers * steps,
            "K4c": layers * steps}
    if totals != want:
        raise AssertionError(f"layers recipe K4 launches {totals}, "
                             f"expected {want}")
    trace = out / "profile" / "trace.json"
    events = timeline.main(["--input", str(trace), "--output",
                            str(out / "timeline.json")])
    streams = [e["args"]["name"] for e in events if e["ph"] == "M"
               and e.get("tid") is not None and e["pid"] != timeline.HOST_PID]
    if not streams:
        raise AssertionError("the timeline has no CUDA-stream track")
    rows = op_table.op_table(trace, "cuda")
    window = LAYERS_WINDOW[1] - LAYERS_WINDOW[0]
    in_window = {}
    for kernel in ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel"):
        hits = [(n, us, c) for n, us, c in rows if n.startswith(kernel)]
        in_window[kernel] = (sum(c for _, _, c in hits),
                             sum(us for _, us, _ in hits))
        if in_window[kernel][0] != layers * window:
            raise AssertionError(f"op table: {kernel} x "
                                 f"{in_window[kernel][0]} in the window, "
                                 f"expected {layers * window}: {hits}; the "
                                 f"table's top rows {rows[:12]}")
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    print(f"{tag}: FastSpeech2 recipe CLI at default.yaml's widths with "
          f"{' '.join(LAYERS_OPTS[:8])}: {steps} steps of {LAYERS_BATCH} "
          f"and an evaluation in {recipe_s:.2f} s, losses "
          + ", ".join(f"{x:.5g}" for x in losses) + f", eval/loss "
          f"{obs['eval/loss']:.5g}; every parameter moved; K4 launches "
          f"{totals}; the profiled window ({window} steps): "
          f"{len(streams)} CUDA-stream track(s) ({', '.join(streams)}), "
          f"{busy_ms:.2f} ms on the card, " + ", ".join(
              f"{k} x {n} ({us / 1e3:.3f} ms)"
              for k, (n, us) in in_window.items())
          + f"; {_layers_tensorboard(out / 'exp' / 'tb', steps)}")
    # (b) K4 on the shapes the run gave it
    k4_records, k4_shapes = _layers_k4(model, lengths)
    print(f"{tag}: K4a/K4b/K4c at the run's shapes, its train batch with "
          f"the most frames: the encoder's and the decoder's "
          f"self-attention (B, T, H, dk) {k4_shapes}, float32, against "
          f"their plain versions (lines 'K4 B=...' above); the two shapes "
          f"together: " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, SDPA "
              f"{r['library_ms']:.4f}), err {r['max_abs_err']:.3g}"
              for r in k4_records.values()))
    # (c) the same model's forward at batch 2 on the card against the CPU
    cfg = Config.from_yaml(FS2_RECIPE_CONF).merge_opts(
        LAYERS_OPTS + ["batch_size", "2"])
    idim = sum(1 for _ in open(md["phones"]))
    cpu_fs2 = train.build_model(cfg, idim, ODIM)
    card_fs2 = train.build_model(cfg, idim, ODIM).cuda()
    batch = next(iter(train.build_dataloader(md["dev"], cfg, False, False)))
    keys = ("text", "text_lengths", "speech", "speech_lengths", "durations",
            "pitch", "energy")
    cpu_b = to_device_batch(batch, torch.device("cpu"))
    card_b = to_device_batch(batch, torch.device("cuda"))
    with torch.no_grad():
        want_o = cpu_fs2(*[cpu_b[k] for k in keys], deterministic=True)
        got_o = card_fs2(*[card_b[k] for k in keys], deterministic=True)
    held = [(k, _hold(f"layers fs2 {k}", got_o[k].cpu(), want_o[k],
                      LAYERS_REL_TOL))
            for k in ("before_outs", "after_outs", "d_outs", "p_outs",
                      "e_outs")]
    print(f"{tag}: the concat_after FastSpeech2 forward (flash, dk 192, "
          f"batch 2, {tuple(batch['speech'].shape[:2])}) on the card "
          f"against the CPU: " + _report(tag, held))
    # (d) TransformerTTS with both flags: teacher-forced card against CPU,
    # and the cached decode as one graph against its eager run
    concat = dict(encoder_concat_after=True, decoder_concat_after=True)

    def tts(rate):
        m = TransformerTTS(idim=IDIM, odim=ODIM, dprenet_dropout_rate=rate,
                           **TRANSFORMER_TTS_CONFIG, **concat)
        init_transformer_tts_(m, torch.Generator().manual_seed(SEED + 71))
        return m.eval()

    cpu_tts = tts(0.0)
    card_tts = tts(0.0).cuda()
    gen = np.random.default_rng(SEED + 72)
    b = len(LAYERS_TTS_TEXT)
    text = np.zeros((b, max(LAYERS_TTS_TEXT)), np.int64)
    for i, n in enumerate(LAYERS_TTS_TEXT):
        text[i, :n] = gen.integers(1, IDIM, n)
    speech = gen.standard_normal((b, max(LAYERS_TTS_FRAMES), ODIM)).astype(
        np.float32)
    args = [torch.as_tensor(a) for a in (text, LAYERS_TTS_TEXT, speech,
                                         LAYERS_TTS_FRAMES)]
    with torch.no_grad():
        want_t = cpu_tts(*args)
        got_t = card_tts(*[a.cuda() for a in args])
    held = [(k, _hold(f"layers tts {k}", got_t[k].cpu(), want_t[k],
                      LAYERS_REL_TOL))
            for k in ("before_outs", "after_outs", "stop_logits",
                      "dec_cross_attns")]
    dec = tts(0.5).cuda()          # the decoder prenet's default rate
    dec.load_state_dict(card_tts.state_dict())
    inputs = {"text": args[0][:1].cuda(),
              "text_lengths": args[1][:1].cuda()}
    keep = dec.prenet_masks(1, LAYERS_TTS_STEPS,
                            torch.Generator().manual_seed(SEED + 73), "cpu")
    inputs["prenet_keep"] = keep.cuda()

    def decode(text, text_lengths, prenet_keep):
        o = dec.inference(text, text_lengths,
                          max_decoder_steps=LAYERS_TTS_STEPS,
                          prenet_keep=prenet_keep)
        return o["mel"], o["lengths"]

    torch.cuda.synchronize()
    tic = time.perf_counter()
    with torch.no_grad():
        eager_mel, eager_len = decode(**inputs)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - tic
    tic = time.perf_counter()
    graph = CapturedProgram(decode, inputs)
    capture_s = time.perf_counter() - tic
    graph_ms = cuda_ms(graph, 3, warmup=1)
    mel, length = graph()
    if not (torch.equal(mel, eager_mel) and torch.equal(length, eager_len)
            and torch.isfinite(mel).all()):
        raise AssertionError("layers: the TransformerTTS decode graph's mel "
                             "is not the eager decode's")
    print(f"{tag}: TransformerTTS at its YAML's widths with both "
          f"concat_after flags, teacher-forced at batch 2 on the card "
          f"against the CPU: " + _report(tag, held) + f"; the cached decode "
          f"of {LAYERS_TTS_STEPS} steps as one CUDA graph bitwise its eager "
          f"run (eager {eager_s:.2f} s, capture {capture_s:.2f} s, a replay "
          f"{graph_ms:.2f} ms, {graph_ms / LAYERS_TTS_STEPS:.3f} ms a step)")
    # (e) the single layers on the card against the CPU, CUDA-event times
    lc_card, lc_cpu = _card_and_cpu(lambda: LightweightConvolution(
        wshare=4, n_feat=LIGHTCONV_C, kernel_size=LIGHTCONV_K, use_bias=True),
        SEED + 74)
    g = torch.Generator().manual_seed(SEED + 75)
    x = torch.randn((LIGHTCONV_B, LIGHTCONV_T, LIGHTCONV_C), generator=g)
    dy = torch.randn(x.shape, generator=g)
    lengths = torch.randint(LIGHTCONV_T // 2, LIGHTCONV_T + 1,
                            (LIGHTCONV_B,), generator=g)
    mask = (torch.arange(LIGHTCONV_T)[None, None, :]
            < lengths[:, None, None])
    results = {}
    for dev, mod in (("cpu", lc_cpu), ("cuda", lc_card)):
        xi = x.detach().to(dev).requires_grad_()
        y = mod(xi, None, None, mask.to(dev))
        y.backward(dy.to(dev))
        results[dev] = (y.detach().cpu(), xi.grad.cpu(),
                        mod.linear1.weight.grad.cpu(), mod.weight.grad.cpu())
    held = [(n, _hold(f"layers lightconv {n}", got, ref,
                      LAYERS_REL_TOL if n == "y" else LAYERS_GRAD_REL_TOL))
            for n, got, ref in zip(("y", "dx", "dlinear1", "dweight"),
                                   results["cuda"], results["cpu"])]
    xc, dyc, mc = x.cuda().requires_grad_(), dy.cuda(), mask.cuda()
    lc_fwd = cuda_ms(lambda: lc_card(xc, None, None, mc), LAYERS_REPS)
    lc_both = cuda_ms(lambda: lc_card(xc, None, None, mc).backward(dyc),
                      LAYERS_REPS)
    print(f"{tag}: LightweightConvolution (wshare 4, n_feat {LIGHTCONV_C}, "
          f"k {LIGHTCONV_K}, B={LIGHTCONV_B}, T={LIGHTCONV_T}) against the "
          f"CPU: " + _report(tag, held) + f"; forward {lc_fwd:.3f} ms, "
          f"forward + backward {lc_both:.3f} ms")
    cell, cpu_cell = _card_and_cpu(lambda: Conv1dCell(
        CELL_C, CELL_C, kernel_size=3, dilation=CELL_DILATION), SEED + 76)
    xs_cpu = torch.randn((CELL_B, LAYERS_TTS_STEPS, CELL_C), generator=g)
    xs = xs_cpu.cuda()

    def loop():
        state = cell.initial_state(CELL_B, device=xs.device)
        ys = []
        for i in range(LAYERS_TTS_STEPS):
            state, y = cell.step(state, xs[:, i])
            ys.append(y)
        return torch.stack(ys, 1)

    with torch.no_grad():
        par, stepped = cell(xs), loop()
        held = [("parallel", _hold("layers Conv1dCell against the CPU",
                                   par.cpu(), cpu_cell(xs_cpu),
                                   LAYERS_REL_TOL)),
                ("steps", _hold("layers Conv1dCell", stepped, par,
                                LAYERS_REL_TOL))]
        loop_ms = cuda_ms(loop, 3, warmup=1)
        par_ms = cuda_ms(lambda: cell(xs), LAYERS_REPS)
    print(f"{tag}: Conv1dCell ({CELL_C} -> {CELL_C}, k 3, dilation "
          f"{CELL_DILATION}, B={CELL_B}) over {LAYERS_TTS_STEPS} frames, "
          f"its parallel call against the CPU's and its steps against its "
          f"parallel call: " + _report(tag, held) + f"; the loop "
          f"{loop_ms:.2f} ms, the parallel call {par_ms:.3f} ms")
    enc = torch.randn((GAUSS_B, GAUSS_L, GAUSS_D), generator=g)
    dur = torch.randint(0, 2 * GAUSS_T // GAUSS_L, (GAUSS_B, GAUSS_L),
                        generator=g)
    dur[:, GAUSS_L * 7 // 8:] = 0          # padded tokens
    want_f, want_n = gaussian_upsample(enc, dur, GAUSS_T)
    enc_c, dur_c = enc.cuda(), dur.cuda()
    got_f, got_n = gaussian_upsample(enc_c, dur_c, GAUSS_T)
    if not torch.equal(got_n.cpu(), want_n):
        raise AssertionError("layers gaussian_upsample totals differ")
    held = [("frames", _hold("layers gaussian_upsample", got_f.cpu(), want_f,
                             LAYERS_REL_TOL))]
    gauss_ms = cuda_ms(lambda: gaussian_upsample(enc_c, dur_c, GAUSS_T),
                       LAYERS_REPS)
    print(f"{tag}: gaussian_upsample (B={GAUSS_B}, L={GAUSS_L}, "
          f"T={GAUSS_T}, D={GAUSS_D}) against the CPU: "
          + _report(tag, held) + f"; {gauss_ms:.3f} ms")
    grads = [[torch.randn(s, generator=g) for s in LAMB_SHAPES]
             for _ in range(LAMB_STEPS)]
    init = [torch.randn(s, generator=g) for s in LAMB_SHAPES]
    final = {}
    for dev in ("cpu", "cuda"):
        params = [torch.nn.Parameter(p.clone().to(dev)) for p in init]
        # the first (1536, 384) as an LSTM cell's four stacked gates
        # (nn/rnn.py): a trust ratio a gate
        params[0]._flax_leaves = 4
        opt = build_optimizer(params, "lamb", 1e-3, max_grad_norm=1.0,
                              weight_decay=0.01)
        for step_grads in grads:
            for p, gr in zip(params, step_grads):
                p.grad = gr.to(dev)
            opt.step()
        final[dev] = params
    held = [(f"p{i}", _hold(f"layers lamb p{i}", a.detach().cpu(),
                            b_.detach(), 2 ** -18))
            for i, (a, b_) in enumerate(zip(final["cuda"], final["cpu"]))]
    lamb_ms = cuda_ms(opt.step, LAYERS_REPS)
    print(f"{tag}: lamb (clip 1, weight decay 0.01) over {LAMB_STEPS} steps "
          f"on {len(LAMB_SHAPES)} tensors ({sum(math.prod(s) for s in LAMB_SHAPES)}"
          f" elements, the first as 4 stacked gates) on the card against "
          f"the CPU: " + _report(tag, held)
          + f"; a step {lamb_ms:.3f} ms")
    shutil.rmtree(out, ignore_errors=True)
    print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s")
    return [dict(k4_records[f"{k}_dk{RECIPE_DK}_layers"], launches=totals[k])
            for k in ("K4a", "K4b", "K4c")]


def _mp_train_step(family, dtype):
    """(step, state, batch) of ``family``'s bench at its shapes, computing
    in flax's ``dtype`` (None: float32)."""
    from parakeet_tpu_torch.benchmarks import (ge2e_train, train_am,
                                               train_fastspeech2)
    cuda = torch.device("cuda")
    if family == "ge2e":
        return ge2e_train.build_train_step(
            *MP_GE2E, cuda, "float32" if dtype is None else "bfloat16")
    if family == "fastspeech2":
        return train_fastspeech2.build_train_step(
            *MP_AM_SHAPE, "flash", cuda, RECIPE_HEADS, dtype)
    return train_am.build_train_step(family, *MP_AM_SHAPE, cuda, dtype)


def _top_gemms(run, tag):
    """The MP_TOP_GEMMS GEMM kernels by card time in a profiled call of
    ``run``, from ``tools/op_table.py`` over its trace (written to a
    temporary directory and removed): [(name, ms, calls)]."""
    import tempfile
    from parakeet_tpu_torch.tools import op_table
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / f"{tag}.json"
        prof.export_chrome_trace(str(trace))
        rows = [(n, us / 1e3, c) for n, us, c
                in op_table.op_table(trace, "cuda") if MP_GEMM.search(n)]
    if not rows:
        raise AssertionError(f"{tag}: no GEMM kernel in the profile")
    return rows[:MP_TOP_GEMMS]


def phase_mixed_precision():
    """Phase 23 (see the module's doc); returns the kernels line's K4
    records of the bf16 FastSpeech2 step."""
    t_phase = time.perf_counter()
    tag = "mixed precision"
    bf16 = torch.bfloat16
    counters = _k4_counters()
    launches = {}
    for family in MP_FAMILIES:
        t0 = time.perf_counter()
        built = {dt: _mp_train_step(family, dt) for dt in (None, bf16)}
        states = {dt: b[1] for dt, b in built.items()}
        losses = {None: [], bf16: []}

        def run(dt):
            step, _, batch = built[dt]
            states[dt], metrics = step(states[dt], batch)
            losses[dt].append(float(metrics["loss"]))

        for dt in (None, bf16):             # warm: the first step of each
            run(dt)
        ms = {None: [], bf16: []}
        for dt in (None, bf16, bf16, None):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(dt)                     # its loss read waits for the card
            ms[dt].append(1e3 * (time.perf_counter() - t1))
        if not all(math.isfinite(x) for v in losses.values() for x in v):
            raise AssertionError(f"{tag} {family}: losses {losses}")
        note = ""
        if family == "fastspeech2":
            for f in counters.values():
                f.launches = 0
            run(bf16)
            launches = {k: f.launches for k, f in counters.items()}
            want = 2 * FS2_CONFIG["elayers"]
            if launches != dict.fromkeys(counters, want):
                raise AssertionError(f"{tag}: the bf16 FastSpeech2 step "
                                     f"launched {launches}")
            gemms = _top_gemms(lambda: run(bf16), "fs2_step_bfloat16")
            note = (f"; the bf16 step launched {launches}; its top GEMMs "
                    "(name ms calls): " + ", ".join(
                        f"{n} {t:.3f} {c}" for n, t, c in gemms))
        mean = {dt: sum(v) / len(v) for dt, v in ms.items()}
        print(f"{tag} {family}: ms a step, float32, bf16, bf16, float32: "
              f"{ms[None][0]:.2f}, {ms[bf16][0]:.2f}, {ms[bf16][1]:.2f}, "
              f"{ms[None][1]:.2f}; bf16 over float32 "
              f"{mean[bf16] / mean[None]:.3f}; last losses "
              f"{losses[None][-1]:.5g} (float32), {losses[bf16][-1]:.5g} "
              f"(bf16), all finite{note} ({time.perf_counter() - t0:.1f} s)")
        del built, states
        torch.cuda.empty_cache()
    # K4a-K4c at the bf16 step's shapes: the encoder's self-attention over
    # its 96 phones and the decoder's over its 640 frames, all valid
    gen = torch.Generator().manual_seed(SEED + 23)
    b, t_text, t_frames = MP_AM_SHAPE
    cases = []
    for t in (t_text, t_frames):
        valid = torch.ones((b, t), dtype=torch.int32, device="cuda")
        cases.append(_k4_case(gen, valid, valid.clone(), RECIPE_HEADS,
                              RECIPE_DK, bf16))
    records = _k4_records(cases, "_bf16_fs2_step", bf16)
    print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s")
    return [dict(records[f"{k}_bf16_fs2_step"], launches=launches[k])
            for k in ("K4a", "K4b", "K4c")]


def run_sh_conf(family, out):
    """``recipes/<family>/conf/default.yaml`` with RUN_SH_CUTS[family]
    set, line by line (a key's line replaced, or added under its section):
    returns the copy's path."""
    lines = pathlib.Path(f"recipes/{family}/conf/default.yaml").read_text(
    ).splitlines()
    for key, value in RUN_SH_CUTS[family].items():
        *section, leaf = key.split(".")
        text = f"{leaf}: {value}"
        if section:
            head = lines.index(f"{section[0]}:")
            end = next((i for i in range(head + 1, len(lines))
                        if lines[i] and not lines[i].startswith(" ")),
                       len(lines))
            hits = [i for i in range(head + 1, end)
                    if lines[i].startswith(f"  {leaf}:")]
            if hits:
                lines[hits[0]] = f"  {text}"
            else:
                lines.insert(head + 1, f"  {text}")
        else:
            hits = [i for i, ln in enumerate(lines)
                    if ln.startswith(f"{leaf}:")]
            if hits:
                lines[hits[0]] = text
            else:
                lines.append(text)
    out = pathlib.Path(out)
    out.write_text("\n".join(lines) + "\n")
    return out


# the program that stands for ``python`` on the twins' PATH: the real
# interpreter running ``-m MODULE`` as python would, with the values of
# the flags in SWAP replaced, which at exit writes the launch counts of
# the kernels' wrappers in that process to $CHIP_SMOKE_LAUNCHES/<pid>.json
_RUN_SH_PYTHON = """#!{exe}
import atexit, json, os, runpy, sys
if sys.argv[1:2] != ["-m"]:
    os.execv({exe!r}, [{exe!r}, *sys.argv[1:]])
module = sys.argv[2]
SWAP = {swap!r}
args = sys.argv[3:]
for i in range(len(args) - 1):
    if args[i] in SWAP:
        args[i + 1] = SWAP[args[i]]
sys.argv = [module, *args]
sys.path.insert(0, os.getcwd())
COUNTERS = {counters!r}


def dump():
    counts = {{}}
    for key, (mod, fn) in COUNTERS.items():
        counts[key] = getattr(getattr(sys.modules.get(mod), fn, None),
                              "launches", 0)
    path = os.path.join(os.environ["CHIP_SMOKE_LAUNCHES"],
                        f"{{os.getpid()}}.json")
    with open(path, "w") as f:
        json.dump({{"module": module, "launches": counts}}, f)


atexit.register(dump)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def _run_sh_stage(family, stage, env, out, log):
    """``bash parakeet_tpu_torch/recipes/<family>/run.sh stage stage`` in
    ``out`` with ``env``: its seconds and the launches its processes
    counted, by kernel.  A non-zero exit raises with the end of its
    output."""
    import os
    import shutil
    counts = out / "launches"
    shutil.rmtree(counts, ignore_errors=True)
    counts.mkdir()
    script = pathlib.Path(f"parakeet_tpu_torch/recipes/{family}/run.sh")
    tic = time.perf_counter()
    with open(log, "a") as f:
        proc = subprocess.run(
            ["bash", str(script.resolve()), str(stage), str(stage)],
            cwd=out, stdout=f, stderr=subprocess.STDOUT, timeout=900,
            env={**os.environ, **{k: str(v) for k, v in env.items()},
                 "CHIP_SMOKE_LAUNCHES": str(counts),
                 "PATH": f"{out / 'bin'}:{os.environ['PATH']}"})
    seconds = time.perf_counter() - tic
    if proc.returncode != 0:
        raise AssertionError(
            f"{family} run.sh stage {stage}: exit {proc.returncode}\n"
            + "\n".join(pathlib.Path(log).read_text().splitlines()[-40:]))
    total = {}
    for path in sorted(counts.glob("*.json")):
        for k, n in json.loads(path.read_text())["launches"].items():
            total[k] = total.get(k, 0) + n
    return seconds, total


def _run_sh_against_plain(what, wav_dir, plain, hop, n_wavs):
    """The twin's ``n_wavs`` wavs under ``wav_dir`` (16-bit PCM): those of
    the in-process plain-K1 run's ``plain`` lines against them within
    K1_REL_TOL of the line's range; returns the largest error as a share
    of the range."""
    from parakeet_tpu_torch.audio import load_wav
    files = {p.stem for p in pathlib.Path(wav_dir).glob("*.wav")}
    if len(files) != n_wavs or not {r["utt_id"] for r in plain} <= files:
        raise AssertionError(f"{what}: wavs {sorted(files)}")
    worst = 0.0
    for r in plain:
        got, _ = load_wav(pathlib.Path(wav_dir) / f"{r['utt_id']}.wav")
        ref = np.asarray(r["wav"], np.float32).reshape(-1)
        scale = max(1.0, float(np.abs(ref).max()))
        err = (float(np.abs(got - ref).max()) if got.shape == ref.shape
               else math.inf)
        if not (np.isfinite(got).all() and got.size == r["frames"] * hop
                and err <= K1_REL_TOL * scale and np.abs(got).max() > 0):
            raise AssertionError(f"{what} {r['utt_id']}: {got.shape} "
                                 f"against {ref.shape}, error {err}")
        worst = max(worst, err / scale)
    return worst


def phase_run_sh(records):
    """Phase 24: the main path through the entry points a user runs: the
    PWGAN twin's ``run.sh`` (stages 0-3: preprocess, normalize, train,
    synthesize) and then the FastSpeech2 twin's (stages 0-3: preprocess,
    normalize, train, synthesize_e2e with the PWGAN run's checkpoint), as
    subprocesses with DEVICE=cuda on a seeded formant corpus at the
    YAMLs' widths (RUN_SH_CUTS).  K1 must launch in both synthesis stages
    (30 a line), K2a, K2b, K3a and K3b (or K3c, by the YAML's vjp_mode) in
    PWGAN's training and K4a-K4c in FastSpeech2's.  Each last stage runs
    again in this process with K1's plain version (PWGAN's on its first
    RUN_SH_PLAIN_LINES dev lines), its wavs held to the twin's.  Returns
    the kernel records with this phase's launches: K1 at PWGAN's
    synthesis shape, K4 at FastSpeech2's train batch (both
    measured here), K2a-K3c with ``records``' numbers (phase 5's, at the
    training shape the recipe runs)."""
    import shutil
    from parakeet_tpu_torch.benchmarks.common import card
    from parakeet_tpu_torch.recipes import corpus
    from parakeet_tpu_torch.recipes.fastspeech2 import \
        synthesize_e2e as fs2_e2e
    from parakeet_tpu_torch.recipes.fastspeech2 import train as fs2_train
    from parakeet_tpu_torch.recipes.pwgan import synthesize as pwg_syn
    from parakeet_tpu_torch.training import Config
    import gc
    name, limit = card(torch.device("cuda"))
    t_phase = time.perf_counter()
    # the twins' processes share the card with this one: hand back what
    # the earlier phases left in the caching allocator
    held = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"run.sh: this process's reserved memory {held / 2 ** 30:.1f} -> "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB before the "
          "twins run")
    out = (pathlib.Path("build") / "chip_smoke_run_sh").resolve()
    shutil.rmtree(out, ignore_errors=True)
    (out / "bin").mkdir(parents=True)
    counters = {k: (f.__module__, f.__name__) for k, f in
                {**_train_counters(), **_k4_counters()}.items()}
    shim = out / "bin" / "python"
    shim.write_text(_RUN_SH_PYTHON.format(exe=sys.executable,
                                          counters=counters,
                                          swap=RUN_SH_SWAP))
    shim.chmod(0o755)
    corpus.write_baker_corpus(out / "corpus", RUN_SH_UTTS, seed=SEED + 60,
                              syllables=RUN_SH_SYLLABLES)
    text = corpus.write_sentences(out / "sentences.txt", corpus.SENTENCES)
    conf = {f: run_sh_conf(f, out / f"{f}.yaml") for f in RUN_SH_CUTS}
    pwg_cfg, fs2_cfg = (Config.from_yaml(conf[f]) for f in
                        ("pwgan", "fastspeech2"))
    layers = pwg_cfg.get("generator_params", {}).get("layers")
    hop = pwg_cfg.n_shift
    vjp = pwg_cfg.get("discriminator_params", {}).get("vjp_mode", "save")
    k3 = "K3b" if vjp == "save" else "K3c"
    log = out / "run_sh.log"
    env = {"ROOTDIR": out / "corpus" / "wavs", "DEVICE": "cuda",
           "TEXT": text}
    runs = {"pwgan": {**env, "CONF": conf["pwgan"], "DUMP": out / "pwg_dump",
                      "EXP": out / "pwg_exp"},
            "fastspeech2": {**env, "CONF": conf["fastspeech2"],
                            "DURFILE": out / "corpus" / "durations.txt",
                            "DUMP": out / "fs2_dump",
                            "EXP": out / "fs2_exp",
                            "PWG_CONF": conf["pwgan"]}}
    seconds, launches, totals = {}, {}, {}
    for k in counters:
        totals[k] = 0
    for family in ("pwgan", "fastspeech2"):
        if family == "fastspeech2":
            runs[family]["PWG_CKPT"] = max(
                (out / "pwg_exp" / "checkpoints").glob("*.npz"),
                key=lambda p: p.stat().st_mtime)
        for stage in range(4):
            sec, total = _run_sh_stage(family, stage, runs[family], out,
                                       log)
            seconds[(family, stage)] = sec
            launches[(family, stage)] = {k: n for k, n in total.items()
                                         if n}
            for k, n in total.items():
                totals[k] += n
    print(f"run.sh ({name}, {limit}; {RUN_SH_UTTS} formant utterances, "
          f"host clock, each stage a bash run of its own): " + "; ".join(
              f"{f} stage {st} {sec:.1f} s" + (
                  f" ({', '.join(f'{k} x {n}' for k, n in launches[(f, st)].items())})"
                  if launches[(f, st)] else "")
              for (f, st), sec in seconds.items())
          + f"; {sum(seconds.values()):.1f} s in all")
    pwg_train, fs2_train_l = launches[("pwgan", 2)], launches[
        ("fastspeech2", 2)]
    want = ["K2a", "K2b", "K3a", k3]
    if any(pwg_train.get(k, 0) == 0 for k in want) or any(
            fs2_train_l.get(k, 0) == 0 for k in ("K4a", "K4b", "K4c")):
        raise AssertionError(f"run.sh: training launched {pwg_train} "
                             f"(PWGAN) and {fs2_train_l} (FastSpeech2)")
    # the last stages again in this process with K1's plain version
    pwg_ckpt = runs["fastspeech2"]["PWG_CKPT"]
    dev = out / "pwg_dump" / "dev" / "norm" / "metadata.jsonl"
    n_dev = len(dev.read_text().splitlines())
    dev_part = out / "plain_dev.jsonl"
    dev_part.write_text("".join(dev.read_text().splitlines(True)
                                [:RUN_SH_PLAIN_LINES]))
    plain_pwg = _with_plain_k1(pwg_syn.main, [
        "--config", str(conf["pwgan"]), "--checkpoint", str(pwg_ckpt),
        "--test-metadata", str(dev_part), "--output-dir",
        str(out / "plain_pwg"), "--device", "cuda"])["lines"]
    fs2_ckpt = max((out / "fs2_exp" / "checkpoints").glob("*.npz"),
                   key=lambda p: p.stat().st_mtime)
    fs2_dump = out / "fs2_dump"
    plain_fs2 = _with_plain_k1(fs2_e2e.main, [
        "--fastspeech2-config", str(conf["fastspeech2"]),
        "--fastspeech2-checkpoint", str(fs2_ckpt), "--fastspeech2-stat",
        str(fs2_dump / "speech_stats.npy"), "--pwg-config",
        str(conf["pwgan"]), "--pwg-checkpoint", str(pwg_ckpt),
        "--phones-dict", str(fs2_dump / "phone_id_map.txt"), "--text",
        str(text), "--output-dir", str(out / "plain_fs2"), "--device",
        "cuda"])["lines"]
    k1_syn = (launches[("pwgan", 3)].get("K1", 0),
              launches[("fastspeech2", 3)].get("K1", 0))
    if (n_dev != 100 or len(plain_fs2) != len(corpus.SENTENCES)
            or k1_syn != (layers * n_dev, layers * len(plain_fs2))):
        raise AssertionError(f"run.sh: {n_dev} dev utterances, "
                             f"{len(plain_fs2)} sentences, K1 x {k1_syn} "
                             "in the synthesis stages")
    worst = (_run_sh_against_plain("pwgan stage 3", out / "pwg_exp" /
                                   "wavs", plain_pwg, hop, n_dev),
             _run_sh_against_plain("fastspeech2 stage 3", out / "fs2_exp" /
                                   "wavs", plain_fs2, hop, len(plain_fs2)))
    frames = [r["frames"] for r in plain_fs2]
    print(f"run.sh: pwgan stage 3's first {len(plain_pwg)} of {n_dev} wavs "
          f"and fastspeech2 stage 3's {len(plain_fs2)} ({min(frames)}-"
          f"{max(frames)} frames) "
          f"against K1's plain version in this process within "
          f"{worst[0]:.3g} and {worst[1]:.3g} of their range (tol "
          f"{K1_REL_TOL:.3g}); K1 x {k1_syn[0]} and x {k1_syn[1]} there")
    # the records: K1 at pwgan/synthesize.py's shape (1,024 frames), K4 at
    # FastSpeech2's train batch, K2a-K3c as phase 5 measured them
    gen = torch.Generator().manual_seed(SEED + 61)
    k1_rec = k1_check(gen, 1, 1024 * hop, name="pwg_residual_stack_run_sh")
    k1_rec["launches"] = totals["K1"]
    model = fs2_train.build_model(fs2_cfg, len((fs2_dump / "phone_id_map.txt")
                                               .read_text().splitlines()),
                                  ODIM)
    loader = fs2_train.build_dataloader(
        fs2_dump / "norm" / "train" / "metadata.jsonl", fs2_cfg, False,
        False)
    batch = {k: torch.as_tensor(v) for k, v in next(iter(loader)).items()}
    k4_records, _ = _layers_k4(model, [batch], tag="run_sh")
    shutil.rmtree(out, ignore_errors=True)
    print(f"run.sh: phase {time.perf_counter() - t_phase:.1f} s")
    return [k1_rec, *[dict(records[k], name=f"{records[k]['name']}_run_sh",
                           launches=totals[k])
                      for k in ("K2a", "K2b", "K3a", k3)],
            *[dict(k4_records[f"{k}_dk{RECIPE_DK}_run_sh"],
                   launches=totals[k]) for k in ("K4a", "K4b", "K4c")]]


# phase 25: the parallel layer.  FastSpeech2 at the recipe's widths
# (FS2_CONFIG) with flash attention (dk 192; one head a rank under --tp 2)
# and every dropout at 0 (the parallel runs draw their masks per rank);
# a global batch of 16 utterances, 512 frames and 64 tokens padded, the
# valid lengths spread down to 350 frames and 48 tokens (so the shards of
# --dp 2 hold unequal numbers of valid frames and tokens); Adam 1e-4
PAR_FS2 = dict(FS2_CONFIG, **dict.fromkeys((
    "duration_predictor_dropout_rate", "energy_predictor_dropout",
    "energy_embed_dropout", "pitch_predictor_dropout", "pitch_embed_dropout",
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate",
    "transformer_dec_attn_dropout_rate", "postnet_dropout_rate"), 0.0))
PAR_B, PAR_FRAMES, PAR_TOKENS, PAR_STEPS = 16, 512, 64, 2
PAR_MICROBATCHES = 2
# --sp 2: one utterance of 64 tokens at 14 frames each, 896 frames
PAR_SP_TOKENS, PAR_SP_FRAMES = 64, 896
PAR_RANKS, PAR_TIMEOUT = 2, 300
PAR_DIR = pathlib.Path("build") / "chip_smoke_parallel"
# the parallel runs against the one-process run on the card, float32
# (TF32 off).  FastSpeech2: the same steps with sums in other orders (the
# shards' losses and gradients averaged, the split heads' and hidden
# units' partial products summed, the microbatches'): the losses 2^-14
# relative (measured <= 3.0e-7), the last step's gradients 2^-12 in
# relative L2 (measured <= 5.6e-5) and the parameters after two Adam
# steps 2^-8 in relative L2 of their difference over the updates'
# (measured <= 1.35e-3, --tp): Adam divides each gradient by its own
# root mean square, so a gradient that is float32 noise in exact
# arithmetic (the k projection's bias under a softmax) moves its
# parameter by ~lr either way, left out of both sums.  PWGAN: each step
# of --dp 2 from the parameters (and Adam state) of the one-process
# run's step: step 0 from the seeded state, step 1 (the discriminator's
# first) from the one-process run's snapshot after step 0, loaded.
# Adam's first steps move a parameter by ~lr times the sign of its
# gradient, so the parameters of two runs part wherever a gradient is
# near zero, and a step from parted parameters is another step; the
# parameters are held by the gradients Adam takes and by the ranks'
# parameters being bit for bit equal after each step (the all-reduced
# gradients stepped alike).  Each network's gradients 2^-8 in relative
# L2 (measured 7.0e-7 at step 0; at step 1 9.0e-6, the discriminator's,
# and 2.4e-4, the generator's: bf16 roundings in K3a/K3b flipped by
# float32 sums in other orders, 4 rows a call and not 8; a second
# one-process step 0 reads 0), the losses PAR_LOSS_REL_TOL (measured
# 8.4e-8).  The wavs' scale rises from 0.05 to 0.5 over the 8 rows, so
# the ranks' gradients differ: a rank that steps on its own
# discriminator gradients reads 0.34 and parts the ranks' parameters.
# The mel of --sp 2: the ring's float32 softmax against K4a's in the
# decoder's four layers and the Postnet, FS2_INFER_REL_TOL (measured
# 7.9e-6).
PAR_LOSS_REL_TOL, PAR_GRAD_REL_L2, PAR_PARAM_REL_L2 = (2 ** -14, 2 ** -12,
                                                       2 ** -8)
PAR_PWG_GRAD_REL_L2, PAR_PWG_WAV_SCALE = 2 ** -8, (0.05, 0.5)


def par_fs2(layer_runner=None, decoder_attn_core=None):
    """PAR_FS2's FastSpeech2 on the card with seeded weights."""
    from parakeet_tpu_torch.models import FastSpeech2
    model = FastSpeech2(IDIM, ODIM, attn_impl="flash",
                        layer_runner=layer_runner,
                        decoder_attn_core=decoder_attn_core, **PAR_FS2)
    seeded_init_(model, torch.Generator().manual_seed(SEED + 25))
    return model.cuda()


def par_fs2_updater(mesh=None, rule=None, pp=False):
    """(StandardUpdater over the FastSpeech2 step on ``mesh`` split by
    ``rule``, the model); ``pp``: the stacks run the pipeline runner."""
    from parakeet_tpu_torch.models import (init_fs2_train_state,
                                           make_fs2_train_step)
    from parakeet_tpu_torch.parallel import make_pp_layer_runner
    from parakeet_tpu_torch.training import (StandardUpdater,
                                             build_optimizer, seed_everything)
    runner = make_pp_layer_runner(mesh, "model",
                                  n_microbatches=PAR_MICROBATCHES) \
        if pp else None
    model = par_fs2(layer_runner=runner)
    opt = build_optimizer(model.parameters(), "adam", FS2_LR)
    state = init_fs2_train_state(model, opt, seed_everything(
        SEED + 27, device="cuda"))
    return StandardUpdater(make_fs2_train_step(model, opt), state, [],
                           mesh=mesh, param_spec_rule=rule), model


def par_pwg_updater(mesh=None):
    """(StandardUpdater over the recipe's GAN step, the discriminator from
    step 1, on ``mesh``, the batches with their noise; the wavs' scale
    rises from row to row, so the ranks' rows differ)."""
    from parakeet_tpu_torch.models import (PWGDiscriminator, PWGGenerator,
                                           init_pwg_train_state,
                                           make_pwg_train_step)
    from parakeet_tpu_torch.training import (StandardUpdater,
                                             build_optimizer, seed_everything)
    gen = torch.Generator().manual_seed(SEED + 28)
    g = PWGGenerator(aux_channels=ODIM, stack_impl="fused", **PWG_CONFIG)
    d = PWGDiscriminator(impl="auto", **DISC_CONFIG)
    seeded_init_(g, gen)
    seeded_init_(d, gen)
    g, d = g.cuda(), d.cuda()
    frames = TRAIN_T // 300 + 2 * PWG_CONFIG["aux_context_window"]
    scale = torch.linspace(*PAR_PWG_WAV_SCALE, TRAIN_B)[:, None]
    batches = [{"wav": (scale * torch.randn((TRAIN_B, TRAIN_T),
                                            generator=gen)).cuda(),
                "mel": torch.randn((TRAIN_B, frames, ODIM),
                                   generator=gen).cuda(),
                "noise": torch.randn((TRAIN_B, TRAIN_T, 1),
                                     generator=gen).cuda()}
               for _ in range(PAR_STEPS)]
    state = init_pwg_train_state(
        g, d, build_optimizer(g.parameters(), "adam", GEN_LR),
        build_optimizer(d.parameters(), "adam", DISC_LR),
        seed_everything(SEED + 29, device="cuda"))
    step = make_pwg_train_step(g, d, lambda_adv=LAMBDA_ADV,
                               discriminator_train_start_steps=1,
                               **STFT_LOSS)
    return StandardUpdater(step, state, [], mesh=mesh), batches


def par_fs2_batches():
    return fs2_batches(torch.Generator().manual_seed(SEED + 26), b=PAR_B,
                       n_frames=PAR_FRAMES, n_tokens=PAR_TOKENS,
                       steps=PAR_STEPS)


def par_sp_inputs():
    gen = torch.Generator().manual_seed(SEED + 30)
    text = torch.randint(1, IDIM, (1, PAR_SP_TOKENS), generator=gen).cuda()
    durations = torch.full((1, PAR_SP_TOKENS), PAR_SP_FRAMES // PAR_SP_TOKENS,
                           dtype=torch.long, device="cuda")
    return text, torch.tensor([PAR_SP_TOKENS], device="cuda"), durations


def _par_steps(updater, batches):
    """(metrics, seconds) of one update a batch, each synchronised."""
    metrics, seconds = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        updater.update_core(batch)
        updater.state.iteration += 1
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in
                        updater.last_metrics.items()})
    return metrics, seconds


def _full_arrays(updater):
    """The updater's parameters and their gradients as full flat arrays
    under the snapshot's keys (the snapshot's gather: a collective under
    a mesh)."""
    from parakeet_tpu_torch.bridge import flax_arrays, flax_grads
    from parakeet_tpu_torch.training.updater import _unstack_flat
    state = updater.train_state
    out = []
    for fn in (flax_arrays, flax_grads):
        flat = {}
        for name, module in state.modules.items():
            scope = "" if len(state.modules) == 1 else name + "::"
            flat.update({"params::" + scope + k[len("params::"):]: v
                         for k, v in fn(module).items()
                         if k.startswith("params::")})
        if updater.mesh is not None:
            flat = _unstack_flat(updater._gathered(flat), updater._stacks)
        out.append(flat)
    return tuple(out)


def _rel_l2(got, want, base=None, skip=()):
    """|got - want| / |want - base| (|want| without ``base``) over the
    keys of ``want`` but those ending in ``skip``, float64."""
    keys = [k for k in want if not k.endswith(skip)]
    num = den = 0.0
    for k in keys:
        w = np.asarray(want[k], np.float64)
        num += float(np.sum((np.asarray(got[k], np.float64).reshape(
            w.shape) - w) ** 2))
        ref = w if base is None else w - np.asarray(base[k], np.float64)
        den += float(np.sum(ref ** 2))
    return math.sqrt(num / den)


def _counted(fn):
    """(fn(), the kernels' launches during it), the counters set to 0 just
    before."""
    counters = {**_train_counters(), **_k4_counters()}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {k: f.launches for k, f in counters.items()}


def _grads_by_net(run, want_g, owner):
    """For each network of the GAN's state with a gradient in ``want_g``
    (flat arrays): the relative L2 of the run's gradients from it (rank
    0; None elsewhere), and a digest of the run's parameters."""
    params, grads = _full_arrays(run)
    digest = hashlib.sha256()
    for k in sorted(params):
        digest.update(np.ascontiguousarray(params[k]).tobytes())
    if not owner:
        return None, digest.hexdigest()
    out = {}
    for net in run.train_state.modules:
        want = {k: v for k, v in want_g.items()
                if k.startswith(f"params::{net}::")}
        if any(np.any(v != 0) for v in want.values()):
            out[net] = _rel_l2(grads, want)
    return out, digest.hexdigest()


def _held(run, ref, owner):
    """A rank's run against the one-process run (``ref``: its arrays,
    gradients and starting parameters, or None off rank 0): the relative
    L2 of the parameters' difference over the updates (the k
    projections' biases left out, see PAR_PARAM_REL_L2) and of the last
    step's gradients."""
    params, grads = _full_arrays(run)
    if not owner:
        return None
    want, want_g, start = ref
    skip = ("::k::bias",)
    return (_rel_l2(params, want, start, skip), _rel_l2(grads, want_g,
                                                        skip=skip))


def parallel_rank(reference, pwg_state):
    """One rank of phase 25 (see ``phase_parallel``): returns its backend,
    the wall time it started at and, for each run, its metrics, seconds a
    step, launches and (rank 0) its distance from the one-process run
    whose arrays ``reference`` (an .npz) holds; ``pwg_state``: the
    one-process GAN run's snapshot after its step 0."""
    import torch.distributed as dist
    from parakeet_tpu_torch.parallel import (fs2_tp_spec, make_mesh,
                                             make_ring_attn_core,
                                             pp_stack_spec)
    from parakeet_tpu_torch.parallel.collectives import backend_of
    from parakeet_tpu_torch.recipes.fastspeech2.synthesize_e2e import vocode
    started = time.time()
    timeline = []

    def mark(label):
        torch.cuda.synchronize()
        timeline.append((label, round(time.time() - started, 2)))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    owner = dist.get_rank() == 0
    ref = {}
    if owner:
        with np.load(reference) as f:
            for key in f.files:
                run, part, rest = key.split("/", 2)
                ref.setdefault(run, {}).setdefault(part, {})[rest] = f[key]
    refs = {run: (r["params"], r["grads"], r["start"])
            for run, r in ref.items()}
    mark("reference read")
    batches = par_fs2_batches()
    out = {"backend": backend_of(), "started": started, "runs": {}}
    meshes = {"dp": (make_mesh(data=2), None, False),
              "tp": (make_mesh(data=1, model=2), fs2_tp_spec, False),
              "pp": (make_mesh(data=1, model=2), pp_stack_spec, True)}
    mark("meshes")
    for name, (mesh, rule, pp) in meshes.items():
        upd, _ = par_fs2_updater(mesh, rule, pp)
        mark(f"{name} built")
        (metrics, sec), launches = _counted(lambda: _par_steps(upd,
                                                               batches))
        mark(f"{name} stepped")
        out["runs"][name] = dict(metrics=metrics, seconds=sec,
                                 launches=launches,
                                 held=_held(upd, refs.get("fs2"), owner))
        mark(f"{name} held")
        del upd
    # save under --tp 2, resume under --dp 2
    upd, _ = par_fs2_updater(meshes["tp"][0], fs2_tp_spec)
    _par_steps(upd, batches[:1])
    PAR_DIR.mkdir(parents=True, exist_ok=True)
    path = PAR_DIR / "tp_snapshot.npz"
    t0 = time.perf_counter()
    upd.save(path)
    dist.barrier()
    upd2, _ = par_fs2_updater(meshes["dp"][0])
    upd2.load(path)
    snapshot_s = time.perf_counter() - t0
    (metrics, sec), launches = _counted(lambda: _par_steps(upd2,
                                                           batches[1:]))
    out["runs"]["resume"] = dict(metrics=metrics, seconds=sec,
                                 launches=launches, snapshot_s=snapshot_s)
    del upd, upd2
    mark("resume")
    # PWGAN --dp 2: step 0 (the generator alone) from the seeded state,
    # then the GAN step (the discriminator's first) from the one-process
    # run's state after its step 0, loaded: each step's gradients are held
    # from the parameters the one-process step had
    pwg, pwg_batches = par_pwg_updater(make_mesh(data=2))
    run = dict(metrics=[], seconds=[], launches={}, held=[], digests=[])
    for i, batch in enumerate(pwg_batches):
        if i:
            pwg.load(pwg_state)
        (metrics, sec), launches = _counted(lambda: _par_steps(pwg,
                                                               [batch]))
        run["metrics"] += metrics
        run["seconds"] += sec
        run["launches"] = {k: run["launches"].get(k, 0) + v
                           for k, v in launches.items()}
        held_i, digest = _grads_by_net(
            pwg, refs[f"pwgan{i}"][1] if owner else None, owner)
        run["held"].append(held_i)
        run["digests"].append(digest)
    out["runs"]["pwgan"] = run
    mark("pwgan")
    g = pwg.train_state.modules["generator"].eval()
    # --sp 2: ring attention in the decoder, rank 0 vocodes
    am = par_fs2(decoder_attn_core=make_ring_attn_core(
        make_mesh(data=1, model=2), "model")).eval()
    text, lengths, durations = par_sp_inputs()

    def synth():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            mel = am.inference(text, lengths, max_frames=PAR_SP_FRAMES,
                               durations=durations)["after_outs"][0]
            wav = vocode(g, mel, SEED) if owner else None
        torch.cuda.synchronize()
        return mel, wav, time.perf_counter() - t0

    (mel, wav, sec), launches = _counted(synth)
    out["runs"]["sp"] = dict(seconds=[sec], launches=launches,
                             mel=mel.float().cpu().numpy(),
                             wav_samples=None if wav is None else
                             int(wav.numel()),
                             wav_finite=None if wav is None else
                             bool(torch.isfinite(wav).all()))
    mark("sp")
    out["timeline"] = timeline
    return out


def nccl_rank():
    """One rank with NCCL (world 1, its own card): a data-parallel
    FastSpeech2 step, then its gradients all-reduced over the group."""
    import torch.distributed as dist
    from parakeet_tpu_torch.parallel import make_mesh
    from parakeet_tpu_torch.parallel.collectives import backend_of
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    upd, model = par_fs2_updater(make_mesh(data=1))
    metrics, _ = _par_steps(upd, par_fs2_batches()[:1])
    grads = torch.cat([p.grad.flatten() for p in model.parameters()
                       if p.grad is not None])
    summed = grads.clone()
    dist.all_reduce(summed)
    torch.cuda.synchronize()
    return dict(backend=backend_of(), loss=metrics[0]["loss"],
                reduce_equal=bool(torch.equal(summed, grads)))


def _reference_run(updater, batches):
    """The one-process run: (metrics, seconds a step, {params, grads,
    start} as flat arrays)."""
    start = _full_arrays(updater)[0]
    (metrics, sec), _ = _counted(lambda: _par_steps(updater, batches))
    params, grads = _full_arrays(updater)
    return metrics, sec, dict(params=params, grads=grads, start=start)


def _loss_err(got, ref, keys):
    return max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
               for g, r in zip(got, ref) for k in keys)


def phase_parallel():
    """Phase 25 (module doc): the two ranks' runs against the one-process
    runs on the card, then the world-1 NCCL step."""
    from parakeet_tpu_torch.parallel.launch import spawn
    t_phase = time.perf_counter()
    checks, held = [], []       # printed before any is asserted
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    # the one-process runs; their arrays go to rank 0 in one file
    upd, _ = par_fs2_updater()
    serial, serial_s, fs2_ref = _reference_run(upd, par_fs2_batches())
    del upd
    # PWGAN: step 0, its snapshot (step 1's start under --dp 2), step 1;
    # then step 0 again in a second run, the one process's own spread
    PAR_DIR.mkdir(parents=True, exist_ok=True)
    pwg_state = PAR_DIR / "pwgan_step0.npz"
    pwg, pwg_batches = par_pwg_updater()
    pwg_serial, pwg_s, pwg_ref0 = _reference_run(pwg, pwg_batches[:1])
    pwg.save(pwg_state)
    more, more_s, pwg_ref1 = _reference_run(pwg, pwg_batches[1:])
    pwg_serial, pwg_s = pwg_serial + more, pwg_s + more_s
    pwg, _ = par_pwg_updater()
    _reference_run(pwg, pwg_batches[:1])
    again = _grads_by_net(pwg, pwg_ref0["grads"], True)[0]["generator"]
    del pwg
    am = par_fs2().eval()
    text, lengths, durations = par_sp_inputs()
    with torch.no_grad():
        mel_want = am.inference(text, lengths, max_frames=PAR_SP_FRAMES,
                                durations=durations)["after_outs"][0]
    mel_want = mel_want.float().cpu().numpy()
    del am
    torch.cuda.empty_cache()
    reference = PAR_DIR / "reference.npz"
    np.savez(reference, **{f"{run}/{part}/{k}": v for run, ref in (
        ("fs2", fs2_ref), ("pwgan0", pwg_ref0), ("pwgan1", pwg_ref1))
        for part, arrays in ref.items() for k, v in arrays.items()})
    # the world-1 NCCL rank starts beside the two gloo ranks: its start-up
    # overlaps theirs
    t0, wall0 = time.perf_counter(), time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nccl_run = pool.submit(spawn, "chip_smoke:nccl_rank", 1,
                               device="cuda", timeout=PAR_TIMEOUT)
        ranks = spawn("chip_smoke:parallel_rank", PAR_RANKS,
                      (str(reference), str(pwg_state)), device="cuda",
                      timeout=PAR_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        nccl = nccl_run.result()[0]
    nccl_s = time.perf_counter() - t0
    print(f"parallel: {PAR_RANKS} ranks on one {card}, backend "
          f"{ranks[0]['backend']}: {spawn_s:.1f} s for the spawn, of which "
          f"start-up {max(r['started'] for r in ranks) - wall0:.1f} s; one "
          f"process a step: FastSpeech2 {serial_s}, PWGAN {pwg_s} s")
    for r, res in enumerate(ranks):
        checks.append((res["backend"] == "gloo", res["backend"]))
        for name, run in res["runs"].items():
            print(f"parallel: rank {r} {name}: seconds a step "
                  f"{[round(x, 4) for x in run['seconds']]}, launches "
                  + json.dumps(run["launches"]))
        print(f"parallel: rank {r} s since its start: "
              + json.dumps(res["timeline"]))
    for name in ("dp", "tp", "pp"):
        for r, res in enumerate(ranks):
            run = res["runs"][name]
            checks.append((all(run["launches"][k] > 0 for k in (
                "K4a", "K4b", "K4c")), (name, r)))
            err = _loss_err(run["metrics"], serial, ("loss",))
            checks.append((err <= PAR_LOSS_REL_TOL, (name, r, err)))
        params, grads = ranks[0]["runs"][name]["held"]
        checks.append((params <= PAR_PARAM_REL_L2, (name, params)))
        checks.append((grads <= PAR_GRAD_REL_L2, (name, grads)))
        run = ranks[0]["runs"][name]
        held.append(f"--{name} 2: losses {err:.1e} relative, parameters "
                    f"{params:.2e} of the update, gradients {grads:.2e}; "
                    f"step 2 {run['seconds'][1]:.4f} s, x"
                    f"{run['seconds'][1] / serial_s[1]:.2f} one process's")
    for r, res in enumerate(ranks):
        run = res["runs"]["resume"]
        err = _loss_err(run["metrics"], serial[1:], ("loss",))
        checks.append((err <= PAR_LOSS_REL_TOL, ("resume", r, err)))
    held.append(f"--tp 2 snapshot resumed under --dp 2: step 2's loss "
                f"{err:.1e} relative from straight training (save and "
                f"load {ranks[0]['runs']['resume']['snapshot_s']:.1f} s)")
    keys = ("generator_loss", "discriminator_loss")
    for r, res in enumerate(ranks):
        run = res["runs"]["pwgan"]
        checks.append((all(run["launches"][k] > 0 for k in (
            "K1", "K2a", "K2b", "K3a", "K3b")), ("pwgan", r)))
        err = _loss_err(run["metrics"], pwg_serial, keys)
        checks.append((err <= PAR_LOSS_REL_TOL, ("pwgan", r, err)))
    run = ranks[0]["runs"]["pwgan"]
    nets = [sorted(h) for h in run["held"]]
    checks.append((nets == [["generator"], ["discriminator", "generator"]],
                   ("pwgan: the networks held at each step", nets)))
    readings = []
    for i, h in enumerate(run["held"]):
        for net, grads in sorted(h.items()):
            checks.append((grads <= PAR_PWG_GRAD_REL_L2,
                           ("pwgan", i, net, grads)))
            readings.append(f"step {i} {net} {grads:.2e}")
    in_step = [len({res["runs"]["pwgan"]["digests"][i] for res in ranks})
               == 1 for i in range(PAR_STEPS)]
    checks.append((all(in_step), ("pwgan: the ranks' parameters", in_step)))
    held.append(f"PWGAN --dp 2: losses {err:.1e} relative; gradients from "
                f"the one-process step's parameters: {', '.join(readings)} "
                f"(a second one-process step 0: {again:.2e}); the ranks' "
                f"parameters bit for bit equal after each step: "
                f"{all(in_step)}; the GAN step {run['seconds'][1]:.4f} s, x"
                f"{run['seconds'][1] / pwg_s[1]:.2f} one process's")
    for r, res in enumerate(ranks):
        run = res["runs"]["sp"]
        checks.append((run["launches"]["K4a"] > 0, ("sp", r)))
        err = float(np.abs(run["mel"] - mel_want).max() / np.ptp(mel_want))
        checks.append((err <= FS2_INFER_REL_TOL, ("sp", r, err)))
    sp0 = ranks[0]["runs"]["sp"]
    checks.append((sp0["launches"]["K1"] == PWG_CONFIG["layers"],
                   ("sp K1", sp0["launches"])))
    checks.append((sp0["wav_finite"] and sp0["wav_samples"]
                   == PAR_SP_FRAMES * 300, ("sp wav", sp0["wav_samples"])))
    checks.append((ranks[1]["runs"]["sp"]["launches"]["K1"] == 0,
                   "sp: rank 1 vocodes nothing"))
    held.append(f"--sp 2: the mel {err:.2e} of its range from one "
                f"process's; rank 0's wav {sp0['wav_samples']} samples")
    checks.append((nccl["backend"] == "nccl" and nccl["reduce_equal"], nccl))
    err = abs(nccl["loss"] - serial[0]["loss"]) / abs(serial[0]["loss"])
    checks.append((err <= PAR_LOSS_REL_TOL, (nccl, serial[0])))
    held.append(f"world-1 {nccl['backend']}: step loss {err:.1e} relative "
                f"from one process's, gradients all-reduced, "
                f"{nccl_s:.1f} s with the spawn; phase "
                f"{time.perf_counter() - t_phase:.1f} s on {card}")
    for line in held:
        print(f"parallel: {line}")
    failed = [what for ok, what in checks if not ok]
    assert not failed, failed


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile one GAN step and one "
                             "FastSpeech2 step into DIR")
    parser.add_argument("--parent", metavar="DIR", default=None,
                        help="also time K1, K2a, K3a, K3b and K3c of the "
                             "checkout in DIR "
                             "(another commit, unpacked with git archive) "
                             "on the same inputs, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def timed(phase, *args):
        """``phase(*args)``, its seconds and the run's so far printed."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s, "
              f"{time.perf_counter() - t_start:.1f} s in all")
        return out

    timed(phase_card)
    parent = None if args.parent is None else load_parent(args.parent)
    k1, k1_cr128 = timed(phase_k1, parent)
    timed(phase_slice, k1)
    timed(phase_serving_graphs)
    timed(phase_e2e)
    timed(phase_stream)
    timed(phase_longform)
    timed(phase_k4a_graphs)
    k2a, k2b, k2a_cr128, k2b_cr128 = timed(phase_k2, parent)
    k3a, k3b, k3c = timed(phase_k3, None if parent is None
                          else parent_module("pwg_disc"))
    timed(phase_train, {"K2a": k2a, "K2b": k2b, "K3a": k3a, "K3b": k3b},
          args.profile)
    k4 = timed(phase_k4)
    timed(phase_fs2_train, k4, args.profile)
    timed(phase_fs2_d512, k4)
    timed(phase_recipe, k3c, {"K1": k1_cr128, "K2a": k2a_cr128,
                              "K2b": k2b_cr128})
    timed(phase_bench)
    timed(phase_fs2_recipe, k4)
    timed(phase_fs2_bench)
    k1_ss = timed(phase_speedyspeech)
    k1_t2 = timed(phase_tacotron2)
    k1_tt = timed(phase_transformer_tts)
    timed(phase_waveflow)
    timed(phase_ge2e)
    timed(phase_voice_cloning)
    k1_text = timed(phase_text_to_wav)
    k1_corpus = timed(phase_corpus)
    k_conv = timed(phase_checkpoints, {"K2a": k2a, "K2b": k2b, "K3a": k3a,
                                       "K3b": k3b})
    k_layers = timed(phase_layers)
    k_mixed = timed(phase_mixed_precision)
    k_run_sh = timed(phase_run_sh, {"K2a": k2a, "K2b": k2b, "K3a": k3a,
                                    "K3b": k3b, "K3c": k3c})
    timed(phase_parallel)
    print(json.dumps({"kernels": [k1, k2a, k2b, k1_cr128, k2a_cr128,
                                  k2b_cr128, k3a, k3b, k3c,
                                  *k4.values(), k1_ss, k1_t2, *k1_tt,
                                  k1_text, *k1_corpus, *k_conv,
                                  *k_layers, *k_mixed, *k_run_sh]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
