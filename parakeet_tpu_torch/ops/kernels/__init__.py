"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version (counterparts of ``parakeet_tpu/ops/pallas``)."""
from .pwg_stack import (fused_residual_stack, fused_residual_stack_reference,
                        fused_stack_supported)

__all__ = ["fused_residual_stack", "fused_residual_stack_reference",
           "fused_stack_supported"]
