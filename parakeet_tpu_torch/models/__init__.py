"""Task models of the port (counterparts of ``parakeet_tpu.models``)."""
from .fastspeech2 import FastSpeech2
from .parallel_wavegan import PWGGenerator, ResidualStack, pwg_inference

__all__ = ["FastSpeech2", "PWGGenerator", "ResidualStack", "pwg_inference"]
