"""Tensor functions of the port (counterparts of ``parakeet_tpu.ops``)."""
from .geometry import time_shift
from .length_regulator import length_regulate
from .masking import sequence_mask
from .normalizer import ZScore
from .positional import sinusoid_position_encoding

__all__ = ["time_shift", "length_regulate", "sequence_mask", "ZScore",
           "sinusoid_position_encoding"]
