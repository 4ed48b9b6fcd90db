"""Kernel K1 (parakeet_tpu_torch/csrc/pwg_stack.cu) against its plain
PyTorch version on the card.  These tests need a CUDA device and the CUDA
toolkit; without them they skip.  On a machine with the card:

    python -m pytest tests/test_torch_cuda.py --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which that machine lacks.)
"""
import pytest
import torch

from parakeet_tpu_torch.models.parallel_wavegan import ResidualStack
from parakeet_tpu_torch.ops.kernels import pwg_stack

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stack(cr, ca, layers, stacks, seed):
    gen = torch.Generator().manual_seed(seed)
    stack = ResidualStack(layers=layers, stacks=stacks, residual_channels=cr,
                          gate_channels=2 * cr, skip_channels=cr,
                          aux_channels=ca)
    with torch.no_grad():
        for p in stack.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return stack, gen


# the kernel and the plain version round at the same points and differ
# only in the order of float32 sums, which now and then flips a bf16
# rounding; 2^-5 of the output's range bounds such flips carried on
REL_TOL = 2 ** -5


@pytest.mark.parametrize("cr,ca,b,t", [(64, 80, 2, 1000), (32, 20, 1, 333),
                                       (64, 13, 3, 129)])
def test_k1_matches_plain_version(cuda, cr, ca, b, t):
    stack, gen = _stack(cr, ca, layers=6, stacks=2, seed=cr + ca)
    stack = stack.to(cuda)
    x = torch.randn((b, t, cr), generator=gen).to(cuda)
    c = torch.randn((b, t, ca), generator=gen).to(cuda)
    kw = dict(dilations=stack.dilations(), stacks=stack.stacks)
    w = stack.fused_weights()
    n0 = pwg_stack.fused_residual_stack.launches
    got_x, got_s = pwg_stack.fused_residual_stack(x, c, w, **kw)
    torch.cuda.synchronize()
    assert pwg_stack.fused_residual_stack.launches - n0 == 6
    want_x, want_s = pwg_stack.fused_residual_stack_reference(x, c, w, **kw)
    assert got_x.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    for got, want in ((got_x.float(), want_x.float()), (got_s, want_s)):
        assert torch.isfinite(got).all()
        tol = REL_TOL * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol


def test_k1_rejects_what_it_does_not_take(cuda):
    stack, _ = _stack(64, 80, layers=6, stacks=2, seed=0)
    w = {k: (v.to(cuda) if v is not None else None)
         for k, v in stack.fused_weights().items()}
    x = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="does not match"):
        pwg_stack.fused_residual_stack(x, torch.zeros((1, 63, 80),
                                                      device=cuda), w,
                                       dilations=stack.dilations(), stacks=2)
    with pytest.raises(ValueError, match="both must be CUDA or both CPU"):
        pwg_stack.fused_residual_stack(x, torch.zeros((1, 64, 80)), w,
                                       dilations=stack.dilations(), stacks=2)
