"""Network modules of the port (counterparts of ``parakeet_tpu.nn``)."""
from .attention import LocationSensitiveAttention
from .conv import SameConv1d
from .dropout import Dropout
from .flash import make_auto_attn_core, make_flash_attn_core
from .postnet import Postnet, Prenet, flax_batch_norm
from .predictors import (DurationPredictor, VarianceEmbedding,
                         VariancePredictor, duration_predictor_loss)
from .rnn import LSTMCell, flip_sequences, lstm_sequence
from .transformer import (EncoderLayer, MultiHeadAttention, MultiLayerConv,
                          PositionalEncoding, PositionwiseFeedForward,
                          ScaledPositionalEncoding, TransformerEncoder)

__all__ = ["SameConv1d", "Dropout", "make_flash_attn_core",
           "make_auto_attn_core", "Postnet", "Prenet", "flax_batch_norm",
           "LocationSensitiveAttention", "LSTMCell", "lstm_sequence",
           "flip_sequences", "DurationPredictor",
           "VarianceEmbedding", "VariancePredictor",
           "duration_predictor_loss", "EncoderLayer", "MultiHeadAttention",
           "MultiLayerConv", "PositionalEncoding", "PositionwiseFeedForward",
           "ScaledPositionalEncoding", "TransformerEncoder"]
