"""Tensor functions of the port (counterparts of ``parakeet_tpu.ops``)."""
from .geometry import time_shift
from .length_regulator import length_regulate
from .losses import (attention_guide, guided_attention_loss, masked_l1_loss,
                     stop_token_bce, weighted_mean)
from .masking import sequence_mask
from .normalizer import ZScore
from .positional import sinusoid_position_encoding
from .ssim import ssim

__all__ = ["time_shift", "length_regulate", "sequence_mask", "ZScore",
           "sinusoid_position_encoding", "ssim", "weighted_mean",
           "masked_l1_loss", "stop_token_bce", "attention_guide",
           "guided_attention_loss"]
