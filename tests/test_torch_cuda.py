"""Kernels K1, K2a/K2b and K3a/K3b (parakeet_tpu_torch/csrc/) against
their plain PyTorch versions on the card.  These tests need a CUDA device
and the CUDA toolkit; without them they skip.  On a machine with the card:

    python -m pytest tests/test_torch_cuda.py --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which that machine lacks.)
"""
import copy

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


# ---- K2a / K2b / K3a / K3b against their plain versions on the card ----
# Same rounding points, other float32 sum orders and the kernels' fast
# tanh and sigmoid: occasional one-ulp bf16 flips carried through the
# layers; 2^-5 of each output's range, as for K1.

def _hold(got, want, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * max(want.abs().max().item(), 1e-6), (what, err)


def _k2_inputs(cuda, cr, ca, b, t, seed):
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    stack, gen = _stack(cr, ca, layers=6, stacks=2, seed=seed)
    stack.to(cuda)
    with torch.no_grad():
        wg, wso, bso = k1.pack_stack_weights(stack.fused_weights(), cr, ca)
    per = 3
    x = torch.randn((b, t, cr), generator=gen).to(cuda)
    c16 = torch.randn((b, t, ca), generator=gen).to(cuda).to(torch.bfloat16)
    dxo = torch.randn((b, t, cr), generator=gen).to(cuda)
    dsk = torch.randn((b, t, cr), generator=gen).to(cuda)
    return (x, c16, wg[:per].to(torch.bfloat16).contiguous(),
            wso[:per].to(torch.bfloat16).contiguous(), bso[:per].contiguous(),
            stack.dilations()[:per], dxo, dsk)


@pytest.mark.parametrize("cr,ca,b,t", [(64, 80, 2, 1000), (32, 20, 1, 333),
                                       (64, 13, 3, 129)])
def test_k2_matches_plain_versions(cuda, cr, ca, b, t):
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    x, c16, wg, wso, bso, dil, dxo, dsk = _k2_inputs(cuda, cr, ca, b, t,
                                                     cr + ca + 7)
    n0 = k1.fused_group_forward_save.launches
    got = k1.fused_group_forward_save(x, c16, wg, wso, bso, dilations=dil)
    assert k1.fused_group_forward_save.launches - n0 == len(dil)
    want = k1.group_forward_reference(x, c16, wg, wso, bso, dilations=dil)
    for name, g, w in zip(("x_next", "skip", "saved"), got, want):
        _hold(g, w, name)
    n0 = k2.fused_group_backward.launches
    dxo_in, dsk_in = dxo.clone(), dsk.clone()
    grads = k2.fused_group_backward(got[2], c16, wg, wso, dxo, dsk,
                                    dilations=dil)
    assert torch.equal(dxo, dxo_in) and torch.equal(dsk, dsk_in)
    assert k2.fused_group_backward.launches - n0 == 3 * len(dil) + 1
    again = k2.fused_group_backward(got[2], c16, wg, wso, dxo, dsk,
                                    dilations=dil)
    want = k2.group_backward_reference(got[2], c16, wg, wso, dxo, dsk,
                                       dilations=dil)
    for name, g, a, w in zip(("dx", "dc", "dwg", "dwso", "dbso"), grads,
                             again, want):
        _hold(g, w, name)
        assert torch.equal(g, a), f"{name} differs between two runs"
    # without weight gradients: the same dx and dc, and no dw launches
    n0 = k2.fused_group_backward.launches
    dx_only = k2.fused_group_backward(got[2], c16, wg, wso, dxo, dsk,
                                      dilations=dil, need_weights=False)
    assert k2.fused_group_backward.launches - n0 == 2 * len(dil)
    assert dx_only[2:] == (None, None, None)
    assert torch.equal(dx_only[0], grads[0])
    assert torch.equal(dx_only[1], grads[1])


@pytest.mark.parametrize("b,t", [(2, 1000), (1, 37), (3, 801)])
def test_k3_matches_plain_versions(cuda, b, t):
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    gen = torch.Generator().manual_seed(b * t)
    kernels = [torch.randn((3, 64, 1 if j == 8 else 64), generator=gen)
               / 14 for j in range(9)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    wk, bk = (a.to(cuda) for a in k3.pack_disc_weights(kernels, biases))
    h = torch.randn((b, t, 64), generator=gen).to(cuda)
    dlog = torch.randn((b, t), generator=gen).to(cuda)
    logits, saved = k3.fused_disc_forward(h, wk, bk, slope=0.2, save=True)
    want = k3.disc_forward_reference(h, wk, bk, slope=0.2)
    _hold(logits, want[0], "logits")
    _hold(saved, want[1], "saved")
    nosave, none = k3.fused_disc_forward(h, wk, bk, slope=0.2, save=False)
    assert none is None and torch.equal(nosave, logits)
    n0 = k3.fused_disc_backward.launches
    grads = k3.fused_disc_backward(saved, dlog, wk, slope=0.2, need_dx=True,
                                   need_weights=True)
    assert k3.fused_disc_backward.launches - n0 == 4
    again = k3.fused_disc_backward(saved, dlog, wk, slope=0.2, need_dx=True,
                                   need_weights=True)
    want = k3.disc_backward_reference(saved, dlog, wk, slope=0.2)
    for name, g, a, w in zip(("dh", "dW", "db"), grads, again, want):
        _hold(g, w, name)
        assert torch.equal(g, a), f"{name} differs between two runs"
    dx_only = k3.fused_disc_backward(saved, dlog, wk, slope=0.2,
                                     need_dx=True, need_weights=False)
    assert dx_only[1] is None and torch.equal(dx_only[0], grads[0])


@pytest.mark.parametrize("impl", ["fused", "auto"])
def test_stack_grads_on_the_card_match_eager(cuda, impl):
    """Under autograd 'fused' trains through K2 and 'auto' runs eager:
    both give every parameter, x and c a gradient, within bf16 accuracy
    (5% of each gradient's range) of the eager stack's."""
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    stack, gen = _stack(64, 80, layers=6, stacks=2, seed=3)
    with torch.no_grad():
        for p in stack.parameters():
            p.mul_(0.3)
    eager = copy.deepcopy(stack)
    eager.impl = "eager"
    stack.impl = impl
    x = torch.randn((2, 500, 64), generator=gen)
    c = torch.randn((2, 500, 80), generator=gen)
    wx, ws = torch.randn(x.shape, generator=gen), torch.randn(x.shape,
                                                               generator=gen)
    grads = []
    k1_n0, k2_n0 = (k1.fused_residual_stack.launches,
                    k2.fused_group_backward.launches)
    for s in (stack.to(cuda), eager.to(cuda)):
        tx = x.to(cuda).requires_grad_()
        tc = c.to(cuda).requires_grad_()
        xf, sk = s(tx, tc)
        ((xf.float() * wx.to(cuda)).sum()
         + (sk * ws.to(cuda)).sum()).backward()
        grads.append([tx.grad, tc.grad] + [p.grad for p in s.parameters()])
    assert k1.fused_residual_stack.launches == k1_n0   # never under grad
    assert (k2.fused_group_backward.launches > k2_n0) == (impl == "fused")
    for got, want in zip(*grads):
        assert got is not None and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 0.05 * want.abs().max().item() + 1e-6
