"""Task models of the port (counterparts of ``parakeet_tpu.models``)."""
from .fastspeech2 import FastSpeech2
from .parallel_wavegan import (PWGDiscriminator, PWGGenerator, ResidualStack,
                               pwg_inference)
from .pwg_updater import (init_pwg_train_state, make_pwg_eval_step,
                          make_pwg_train_step)

__all__ = ["FastSpeech2", "PWGGenerator", "PWGDiscriminator",
           "ResidualStack", "pwg_inference", "init_pwg_train_state",
           "make_pwg_train_step", "make_pwg_eval_step"]
