"""Task models of the port (counterparts of ``parakeet_tpu.models``)."""
from .fastspeech2 import FastSpeech2, fastspeech2_loss
from .fs2_updater import (init_fs2_train_state, make_fs2_eval_step,
                          make_fs2_train_step)
from .ge2e_updater import init_ge2e_train_state, make_ge2e_train_step
from .lstm_speaker_encoder import (LSTMSpeakerEncoder, compute_eer,
                                   embed_utterance, ge2e_loss,
                                   partial_slices, scale_wb_gradients,
                                   similarity_matrix)
from .parallel_wavegan import (PWGDiscriminator, PWGGenerator,
                               ResidualPWGDiscriminator, ResidualStack,
                               pwg_inference, pwg_streaming_inference,
                               pwg_window_program)
from .pwg_updater import (init_pwg_train_state, make_pwg_eval_step,
                          make_pwg_train_step)
from .speedyspeech import SpeedySpeech, speedyspeech_loss
from .speedyspeech_updater import (init_speedyspeech_train_state,
                                   make_speedyspeech_eval_step,
                                   make_speedyspeech_train_step)
from .tacotron2 import Tacotron2, init_tacotron2_, tacotron2_loss
from .tacotron2_updater import (init_tacotron2_train_state,
                                make_tacotron2_eval_step,
                                make_tacotron2_predict_step,
                                make_tacotron2_train_step)
from .transformer_tts import (TransformerTTS, guided_multihead_attention_loss,
                              init_transformer_tts_, transformer_tts_loss)
from .transformer_tts_updater import (init_transformer_tts_train_state,
                                      make_transformer_tts_eval_step,
                                      make_transformer_tts_predict_step,
                                      make_transformer_tts_train_step)
from .waveflow import (ConditionalWaveFlow, UpsampleNet, WaveFlow, fold,
                       init_waveflow_, unfold, waveflow_loss)
from .waveflow_updater import (init_waveflow_train_state,
                               make_waveflow_eval_step,
                               make_waveflow_train_step)

__all__ = ["FastSpeech2", "fastspeech2_loss", "init_fs2_train_state",
           "make_fs2_train_step", "make_fs2_eval_step", "PWGGenerator",
           "PWGDiscriminator", "ResidualPWGDiscriminator", "ResidualStack",
           "pwg_inference", "pwg_streaming_inference",
           "pwg_window_program", "init_pwg_train_state",
           "make_pwg_train_step", "make_pwg_eval_step", "SpeedySpeech",
           "speedyspeech_loss", "init_speedyspeech_train_state",
           "make_speedyspeech_train_step", "make_speedyspeech_eval_step",
           "Tacotron2", "tacotron2_loss", "init_tacotron2_",
           "init_tacotron2_train_state", "make_tacotron2_train_step",
           "make_tacotron2_eval_step", "make_tacotron2_predict_step",
           "TransformerTTS", "transformer_tts_loss",
           "guided_multihead_attention_loss", "init_transformer_tts_",
           "init_transformer_tts_train_state",
           "make_transformer_tts_train_step",
           "make_transformer_tts_eval_step",
           "make_transformer_tts_predict_step", "ConditionalWaveFlow",
           "UpsampleNet", "WaveFlow", "fold", "unfold", "init_waveflow_",
           "waveflow_loss", "init_waveflow_train_state",
           "make_waveflow_train_step", "make_waveflow_eval_step",
           "LSTMSpeakerEncoder", "ge2e_loss", "similarity_matrix",
           "scale_wb_gradients", "compute_eer", "partial_slices",
           "embed_utterance", "init_ge2e_train_state",
           "make_ge2e_train_step"]
