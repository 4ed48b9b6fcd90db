"""parakeet_tpu_torch: the PyTorch/CUDA port of parakeet_tpu.

The JAX package ``parakeet_tpu`` stays the reference; this package mirrors
its module layout and public names so that each counterpart is easy to
find, and is held against it by the ``tests/test_torch_*.py`` parity
tests.  It imports ``torch`` and never ``jax``, ``flax`` or ``yaml``.

Ported so far: the serving main path, phone ids -> ``FastSpeech2.inference``
-> edge-padded mel -> ``PWGGenerator`` -> waveform, inference only.  The
Parallel WaveGAN residual stack runs through a hand-written CUDA kernel
(``ops/kernels/pwg_stack.py``, source in ``csrc/pwg_stack.cu``) on CUDA
tensors and through its plain PyTorch version on CPU tensors.

Subpackages
-----------
ops       tensor functions: masking, positions, length regulation, kernels
nn        FastSpeech2 building blocks: transformer, predictors, postnet
models    FastSpeech2 (inference) and the Parallel WaveGAN generator
bridge    load a flattened flax parameter tree into a port module
serving   bucketed batched synthesis engine
"""

__version__ = "0.1.0"
