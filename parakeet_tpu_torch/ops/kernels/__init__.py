"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version (counterparts of ``parakeet_tpu/ops/pallas`` and of the Pallas
flash-attention kernel that ``parakeet_tpu/nn/flash.py`` wraps)."""
from .flash_attn import (flash_attention, flash_attention_dkv,
                         flash_attention_dkv_reference, flash_attention_dq,
                         flash_attention_dq_reference,
                         flash_attention_forward, flash_attention_reference)
from .pwg_disc import (disc_backward_reference, disc_forward_reference,
                       fused_disc_backward, fused_disc_forward,
                       fused_disc_supported, fused_disc_tail)
from .pwg_stack import (fused_group_forward_save, fused_residual_stack,
                        fused_residual_stack_reference, fused_stack_supported,
                        group_forward_reference)
from .pwg_stack_train import (fused_group_backward,
                              fused_residual_stack_train,
                              group_backward_reference)

__all__ = ["fused_residual_stack", "fused_residual_stack_reference",
           "fused_stack_supported", "fused_group_forward_save",
           "group_forward_reference", "fused_group_backward",
           "group_backward_reference", "fused_residual_stack_train",
           "fused_disc_tail", "fused_disc_supported", "fused_disc_forward",
           "fused_disc_backward", "disc_forward_reference",
           "disc_backward_reference", "flash_attention",
           "flash_attention_forward", "flash_attention_dkv",
           "flash_attention_dq", "flash_attention_reference",
           "flash_attention_dkv_reference", "flash_attention_dq_reference"]
