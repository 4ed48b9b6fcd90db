"""Network modules of the port (counterparts of ``parakeet_tpu.nn``)."""
from .conv import SameConv1d
from .postnet import Postnet
from .predictors import DurationPredictor, VarianceEmbedding, VariancePredictor
from .transformer import (EncoderLayer, MultiHeadAttention, MultiLayerConv,
                          PositionalEncoding, PositionwiseFeedForward,
                          ScaledPositionalEncoding, TransformerEncoder)

__all__ = ["SameConv1d", "Postnet", "DurationPredictor", "VarianceEmbedding",
           "VariancePredictor", "EncoderLayer", "MultiHeadAttention",
           "MultiLayerConv", "PositionalEncoding", "PositionwiseFeedForward",
           "ScaledPositionalEncoding", "TransformerEncoder"]
