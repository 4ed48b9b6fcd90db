"""parakeet_tpu_torch: the PyTorch/CUDA port of parakeet_tpu.

The JAX package ``parakeet_tpu`` stays the reference; this package mirrors
its module layout and public names so that each counterpart is easy to
find, and is held against it by the ``tests/test_torch_*.py`` parity
tests.  It imports ``torch`` and never ``jax``, ``flax`` or ``yaml``.

Ported so far: the serving main path, phone ids -> ``FastSpeech2.inference``
-> edge-padded mel -> ``PWGGenerator`` -> waveform, the Parallel WaveGAN
training step (``models/pwg_updater.py``) and the FastSpeech2 training
step (``models/fs2_updater.py``), both through ``training.Trainer``.  The
PWG residual stack and discriminator and flash attention run through
hand-written CUDA kernels (``ops/kernels/``, sources in ``csrc/``) on
CUDA tensors and through their plain PyTorch versions on CPU tensors.

Subpackages
-----------
ops       tensor functions: masking, positions, length regulation, kernels
nn        FastSpeech2 building blocks: transformer, flash-attention core,
          dropout, predictors, postnet
models    FastSpeech2, the Parallel WaveGAN generator and discriminator,
          and the FastSpeech2 and PWGAN train and eval steps
training  trainer, updater, optimizers, train state, seeding
utils     profiler windows on torch.profiler
bridge    load a flattened flax parameter tree into a port module
serving   bucketed batched synthesis engine
"""

__version__ = "0.1.0"
