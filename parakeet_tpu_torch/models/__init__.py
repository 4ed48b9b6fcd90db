"""Task models of the port (counterparts of ``parakeet_tpu.models``)."""
from .fastspeech2 import FastSpeech2, fastspeech2_loss
from .fs2_updater import (init_fs2_train_state, make_fs2_eval_step,
                          make_fs2_train_step)
from .parallel_wavegan import (PWGDiscriminator, PWGGenerator, ResidualStack,
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

__all__ = ["FastSpeech2", "fastspeech2_loss", "init_fs2_train_state",
           "make_fs2_train_step", "make_fs2_eval_step", "PWGGenerator", "PWGDiscriminator",
           "ResidualStack", "pwg_inference", "pwg_streaming_inference",
           "pwg_window_program", "init_pwg_train_state",
           "make_pwg_train_step", "make_pwg_eval_step", "SpeedySpeech",
           "speedyspeech_loss", "init_speedyspeech_train_state",
           "make_speedyspeech_train_step", "make_speedyspeech_eval_step",
           "Tacotron2", "tacotron2_loss", "init_tacotron2_",
           "init_tacotron2_train_state", "make_tacotron2_train_step",
           "make_tacotron2_eval_step", "make_tacotron2_predict_step"]
