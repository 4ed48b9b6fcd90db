"""Kernels K1, K2a/K2b, K3a/K3b/K3c and K4a-K4c (parakeet_tpu_torch/csrc/)
against their plain PyTorch versions on the card.  These tests need a CUDA device
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


# K3c against its plain version, which rebuilds the layer inputs in
# another float32 sum order: a pre-activation near zero may take the other
# LeakyReLU slope, which moves a few rows of dh by up to ~10% of its
# range; held in relative L2 (as chip_smoke.py holds it)
K3C_REL_L2 = 2 ** -4
# K3c against K3b: the same rebuilt streams and reverse pass, so dh is
# bitwise K3b's; dW and db are summed by tile instead of by chunk of rows
K3C_VS_K3B_TOL = 2 ** -14


@pytest.mark.parametrize("b,t", [(2, 1000), (1, 37), (3, 801), (2, 30000)])
def test_k3c_matches_plain_version_and_k3b(cuda, b, t):
    """(2, 30000) has more tiles than the card has SMs, so a block walks
    several."""
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    gen = torch.Generator().manual_seed(b * t + 1)
    kernels = [torch.randn((3, 64, 1 if j == 8 else 64), generator=gen)
               / 14 for j in range(9)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    wk, bk = (a.to(cuda) for a in k3.pack_disc_weights(kernels, biases))
    h = torch.randn((b, t, 64), generator=gen).to(cuda).to(torch.bfloat16)
    dlog = torch.randn((b, t), generator=gen).to(cuda)
    n0 = k3.fused_disc_backward_recompute.launches
    grads = k3.fused_disc_backward_recompute(h, dlog, wk, bk, slope=0.2,
                                             need_dx=True, need_weights=True)
    assert k3.fused_disc_backward_recompute.launches - n0 == 3
    again = k3.fused_disc_backward_recompute(h, dlog, wk, bk, slope=0.2,
                                             need_dx=True, need_weights=True)
    want = k3.disc_backward_recompute_reference(h, dlog, wk, bk, slope=0.2)
    for name, g, a, w in zip(("dh", "dW", "db"), grads, again, want):
        assert torch.isfinite(g).all(), name
        rel = ((g - w).norm() / w.norm()).item()
        assert rel <= K3C_REL_L2, (name, rel)
        assert torch.equal(g, a), f"{name} differs between two runs"
    _, saved = k3.fused_disc_forward(h, wk, bk, slope=0.2, save=True)
    save_path = k3.fused_disc_backward(saved, dlog, wk, slope=0.2,
                                       need_dx=True, need_weights=True)
    assert torch.equal(grads[0], save_path[0])
    for name, g, w in zip(("dW", "db"), grads[1:], save_path[1:]):
        err = (g - w).abs().max().item()
        assert err <= K3C_VS_K3B_TOL * w.abs().max().item(), (name, err)
    n0 = k3.fused_disc_backward_recompute.launches
    dx_only = k3.fused_disc_backward_recompute(
        h, dlog, wk, bk, slope=0.2, need_dx=True, need_weights=False)
    w_only = k3.fused_disc_backward_recompute(
        h, dlog, wk, bk, slope=0.2, need_dx=False, need_weights=True)
    assert k3.fused_disc_backward_recompute.launches - n0 == 1 + 3
    assert dx_only[1] is None and torch.equal(dx_only[0], grads[0])
    assert w_only[0] is None and torch.equal(w_only[1], grads[1])


def test_disc_recompute_grads_on_the_card_match_save(cuda):
    """PWGDiscriminator(impl='fused') trains through K3a without saving and
    K3c with vjp_mode='recompute', and through K3a saving and K3b with
    'save': the same gradients (the wav's bitwise up to layer 0's
    backward, the weights' within K3c's tolerance against K3b), and
    within bf16 accuracy of the eager float32 module's: 2^-5 in relative
    L2 (the plain versions on the CPU measured at most 0.0084)."""
    from parakeet_tpu_torch.models.parallel_wavegan import PWGDiscriminator
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    gen = torch.Generator().manual_seed(5)
    wav = 0.3 * torch.randn((2, 3000, 1), generator=gen)
    ct = torch.randn((2, 3000, 1), generator=gen)
    grads = {}
    ref = None
    for impl, mode in (("fused", "save"), ("fused", "recompute"),
                       ("eager", "save")):
        d = PWGDiscriminator(impl=impl, vjp_mode=mode)
        if ref is None:
            with torch.no_grad():
                for p in d.parameters():
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            ref = d.state_dict()
        d.load_state_dict(ref)
        d.to(cuda)
        before = (k3.fused_disc_forward.saves,
                  k3.fused_disc_backward.launches,
                  k3.fused_disc_backward_recompute.launches)
        x = wav.to(cuda).requires_grad_()
        (d(x) * ct.to(cuda)).sum().backward()
        after = (k3.fused_disc_forward.saves,
                 k3.fused_disc_backward.launches,
                 k3.fused_disc_backward_recompute.launches)
        launched = [a - b for a, b in zip(after, before)]
        if impl == "fused":
            assert launched == ([1, 4, 0] if mode == "save" else [0, 0, 3])
        grads[impl, mode] = [x.grad] + [p.grad for p in d.parameters()]
    for got, want, full in zip(grads["fused", "recompute"],
                               grads["fused", "save"],
                               grads["eager", "save"]):
        err = (got - want).abs().max().item()
        assert err <= K3C_VS_K3B_TOL * want.abs().max().item() + 1e-7
        rel = ((got - full).norm() / full.norm()).item()
        assert rel <= 2 ** -5, rel


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


# ---- K4 (flash attention) against its plain versions on the card ----
# Relative to each output's range, as chip_smoke.py holds them: float32
# (3xTF32 products, other sum orders) 2^-14; bf16 (bf16 outputs, an
# occasional flip of p's or ds's bf16 rounding) 2^-7.
K4_TOL = {torch.float32: 2 ** -14, torch.bfloat16: 2 ** -7}


def _k4_inputs(cuda, b, h, tq, tk, d, dtype, key_lengths, mask_rows, seed):
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, h, tq, d), generator=gen).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn((b, h, tk, d), generator=gen).to(cuda, dtype)
            for _ in range(2))
    kv_valid = (torch.arange(tk)[None] < torch.tensor(key_lengths)[:, None])
    kv_valid = kv_valid.to(cuda, torch.int32)
    q_valid = (kv_valid.clone() if mask_rows
               else torch.ones((b, tq), dtype=torch.int32, device=cuda))
    return q, k, v, q_valid, kv_valid, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,tq,tk,d,key_lengths,mask_rows", [
    (2, 2, 200, 200, 32, (200, 131), True),
    (1, 3, 77, 150, 48, (150,), False),
    (2, 1, 300, 300, 128, (300, 17), False),
    # FastSpeech2's encoder self-attention (flash_sweep widths, 64 tokens)
    (4, 4, 64, 64, 96, (64, 48, 57, 50), False)])
def test_k4_matches_plain_versions(cuda, dtype, b, h, tq, tk, d,
                                   key_lengths, mask_rows):
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    q, k, v, qv, kv, do = _k4_inputs(cuda, b, h, tq, tk, d, dtype,
                                     key_lengths, mask_rows, tq + d)
    args, scale = (q, k, v, qv, kv), d ** -0.5
    n0 = k4.flash_attention_forward.launches
    o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
    assert k4.flash_attention_forward.launches - n0 == 1
    want_o, want_lse = k4.flash_attention_reference(*args, sm_scale=scale)
    tol = K4_TOL[dtype]

    def hold(got, want, what):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), what
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (what, err)

    assert o.dtype == dtype and lse.dtype == torch.float32
    hold(o, want_o, "o")
    hold(lse, want_lse, "lse")
    di = (o.float() * do.float()).sum(-1)
    bwd = args + (do, lse, di)
    grads = (k4.flash_attention_dq(*bwd, sm_scale=scale),
             *k4.flash_attention_dkv(*bwd, sm_scale=scale))
    again = (k4.flash_attention_dq(*bwd, sm_scale=scale),
             *k4.flash_attention_dkv(*bwd, sm_scale=scale))
    want = (k4.flash_attention_dq_reference(*bwd, sm_scale=scale),
            *k4.flash_attention_dkv_reference(*bwd, sm_scale=scale))
    for name, g, a, w in zip(("dq", "dk", "dv"), grads, again, want):
        assert g.dtype == dtype
        hold(g, w, name)
        assert torch.equal(g, a), f"{name} differs between two runs"


def test_k4_autograd_matches_autograd_of_the_plain_version(cuda):
    """The autograd Function (K4a forward, K4b and K4c backward) gives q, k
    and v the gradients that autograd through the plain float32 forward
    gives; one launch of each kernel."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    q, k, v, qv, kv, w = _k4_inputs(cuda, 2, 2, 150, 150, 64, torch.float32,
                                    (150, 90), False, 5)
    counters = (k4.flash_attention_forward, k4.flash_attention_dkv,
                k4.flash_attention_dq)
    grads = []
    for kernel in (True, False):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        n0 = [f.launches for f in counters]
        if kernel:
            out = k4.flash_attention(tq, tk, tv, qv, kv)
        else:
            out, _ = k4.flash_attention_reference(tq, tk, tv, qv, kv,
                                                  sm_scale=64 ** -0.5)
        (out * w).sum().backward()
        assert [f.launches - m for f, m in zip(counters, n0)] == (
            [1, 1, 1] if kernel else [0, 0, 0])
        grads.append((tq.grad, tk.grad, tv.grad))
    for got, want in zip(*grads):
        assert got is not None and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= K4_TOL[torch.float32] * want.abs().max().item()


def test_k4_rejects_what_it_does_not_take(cuda):
    from parakeet_tpu_torch.nn.flash import make_flash_attn_core
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    q, k, v, qv, kv, _ = _k4_inputs(cuda, 1, 1, 64, 64, 192, torch.float32,
                                    (64,), False, 0)
    with pytest.raises(NotImplementedError, match="K4"):
        k4.flash_attention_forward(q, k, v, qv, kv, sm_scale=1.0)
    x = torch.zeros((1, 64, 1, 192), device=cuda)
    with pytest.raises(NotImplementedError, match="K4"):
        make_flash_attn_core()(x, x, x)
    half = torch.zeros((1, 1, 64, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="K4"):
        k4.flash_attention_forward(half, half, half, qv, kv, sm_scale=1.0)
    q32 = torch.zeros((1, 1, 64, 32), device=cuda)
    with pytest.raises(ValueError, match="every tensor"):
        k4.flash_attention_forward(q32, q32, q32, qv.cpu(), kv,
                                   sm_scale=1.0)
