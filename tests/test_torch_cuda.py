"""Kernels K1, K2a/K2b, K3a/K3b/K3c and K4a-K4c (parakeet_tpu_torch/csrc/)
against their plain PyTorch versions on the card.  These tests need a CUDA device
and the CUDA toolkit; without them they skip.  On a machine with the card:

    python -m pytest tests/test_torch_cuda.py --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which that machine lacks.)
"""
import copy

import numpy as np
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


def _k2_inputs(cuda, cr, ca, b, t, seed, layers=6, stacks=2):
    """One group's inputs: the first of ``stacks`` groups of a stack of
    ``layers`` layers (dilations 1, 2, 4, ...)."""
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    stack, gen = _stack(cr, ca, layers=layers, stacks=stacks, seed=seed)
    stack.to(cuda)
    with torch.no_grad():
        wg, wso, bso = k1.pack_stack_weights(stack.fused_weights(), cr, ca)
    per = layers // stacks
    x = torch.randn((b, t, cr), generator=gen).to(cuda)
    c16 = torch.randn((b, t, ca), generator=gen).to(cuda).to(torch.bfloat16)
    dxo = torch.randn((b, t, cr), generator=gen).to(cuda)
    dsk = torch.randn((b, t, cr), generator=gen).to(cuda)
    return (x, c16, wg[:per].to(torch.bfloat16).contiguous(),
            wso[:per].to(torch.bfloat16).contiguous(), bso[:per].contiguous(),
            stack.dilations()[:per], dxo, dsk)


@pytest.mark.parametrize("cr,ca,b,t,layers,stacks", [
    (64, 80, 2, 1000, 6, 2), (32, 20, 1, 333, 6, 2), (64, 13, 3, 129, 6, 2),
    # a full group of ten layers (dilations 1...512): the d = 256 and 512
    # taps fall off both ends of every item and cross tile edges inside it
    (64, 80, 3, 700, 10, 1),
    # B * T = 4133, a multiple of no tile or chunk size
    (64, 80, 1, 4133, 6, 2),
    # aux widths that are not multiples of 8, with many tiles a chunk
    (32, 20, 2, 9001, 10, 1), (64, 13, 2, 8999, 6, 2),
    # the recipe's widths, ten layers, chunks of many tiles
    (64, 80, 4, 20000, 10, 1)])
def test_k2_matches_plain_versions(cuda, cr, ca, b, t, layers, stacks):
    from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    x, c16, wg, wso, bso, dil, dxo, dsk = _k2_inputs(
        cuda, cr, ca, b, t, cr + ca + 7, layers, stacks)
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
    assert k2.fused_group_backward.launches - n0 == k2.k2b_launches(len(dil))
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
    assert k2.fused_group_backward.launches - n0 == k2.k2b_launches(
        len(dil), need_weights=False)
    assert dx_only[2:] == (None, None, None)
    assert torch.equal(dx_only[0], grads[0])
    assert torch.equal(dx_only[1], grads[1])


# K1 and K2a at the edges of their tiles and widths: T below a warp's
# 16-row tile, below a block's 8 tiles and below the largest dilation (512
# in a group of ten), items whose ends fall inside a tile, aux widths that
# are not multiples of 8 (the kernel reads aux_rows' [c | 1 | 0]), seven
# warps a block (cr 64, ca >= 96), and the recipe's widths.  Each kernel
# must give the same bits on a second run.
@pytest.mark.parametrize("cr,ca,b,t,layers,stacks", [
    (64, 80, 3, 7, 10, 1), (64, 80, 2, 37, 10, 1), (64, 80, 1, 300, 10, 1),
    (64, 80, 3, 1001, 6, 2), (32, 13, 2, 999, 6, 2),
    (64, 13, 3, 777, 10, 1), (64, 100, 2, 1500, 6, 2),
    (64, 127, 3, 65, 10, 1), (64, 80, 4, 20000, 30, 3)])
def test_k1_k2a_edges_match_plain_versions(cuda, cr, ca, b, t, layers,
                                           stacks):
    stack, gen = _stack(cr, ca, layers, stacks, seed=cr + ca + t)
    stack = stack.to(cuda)
    x = torch.randn((b, t, cr), generator=gen).to(cuda)
    c = torch.randn((b, t, ca), generator=gen).to(cuda)
    kw = dict(dilations=stack.dilations(), stacks=stacks)
    w = stack.fused_weights()
    n0 = pwg_stack.fused_residual_stack.launches
    got = pwg_stack.fused_residual_stack(x, c, w, **kw)
    assert pwg_stack.fused_residual_stack.launches - n0 == layers
    again = pwg_stack.fused_residual_stack(x, c, w, **kw)
    want = pwg_stack.fused_residual_stack_reference(x, c, w, **kw)
    for name, g, a, r in zip(("x", "skip"), got, again, want):
        _hold(g, r, f"K1 {name}")
        assert torch.equal(g, a), f"K1 {name} differs between two runs"

    x, c16, wg, wso, bso, dil, _, _ = _k2_inputs(
        cuda, cr, ca, b, t, cr + ca + t + 1, layers, stacks)
    n0 = pwg_stack.fused_group_forward_save.launches
    got = pwg_stack.fused_group_forward_save(x, c16, wg, wso, bso,
                                             dilations=dil)
    assert pwg_stack.fused_group_forward_save.launches - n0 == len(dil)
    again = pwg_stack.fused_group_forward_save(x, c16, wg, wso, bso,
                                               dilations=dil)
    want = pwg_stack.group_forward_reference(x, c16, wg, wso, bso,
                                             dilations=dil)
    for name, g, a, r in zip(("x_next", "skip", "saved"), got, again, want):
        _hold(g, r, f"K2a {name}")
        assert torch.equal(g, a), f"K2a {name} differs between two runs"


@pytest.mark.parametrize("cr", [32, 64])
def test_k1_shared_memory_matches_the_kernel(cuda, cr):
    """The launcher's ``k1_smem_bytes`` is the kernel's own count
    (``pwg_stack_smem``), within the card's 227 KB, at aux widths from the
    narrowest to the widest, across the switch to seven warps a block."""
    import ctypes

    from parakeet_tpu_torch.ops.kernels._build import load_library
    fn = load_library().cdll.pwg_stack_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    for ca in (1, 13, 20, 80, 95, 96, 127):
        kp = 3 * cr + -(-(ca + 1) // 16) * 16
        want = pwg_stack.k1_smem_bytes(cr, ca)
        assert fn(cr, kp) == want <= pwg_stack.SMEM_LIMIT, ca


@pytest.mark.parametrize("cr", [32, 64])
def test_k2b_shared_memory_matches_the_kernels(cuda, cr):
    """The launcher's ``k2b_smem_bytes`` is the kernels' own count
    (``pwg_stack_bwd_smem``), within the card's 227 KB, at every aux width
    the kernels take from the narrowest to the widest."""
    import ctypes

    from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2
    from parakeet_tpu_torch.ops.kernels._build import load_library
    fn = load_library().cdll.pwg_stack_bwd_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for ca in (1, 13, 20, 80, 127):
        kp, cap = 3 * cr + -(-(ca + 1) // 16) * 16, -(-ca // 16) * 16
        want = k2.k2b_smem_bytes(cr, ca)
        for i, kind in enumerate(("gate", "dw", "dx")):
            assert fn(i, cr, kp, cap) == want[kind] <= k2.SMEM_LIMIT


# K3a's edges (tiles of 400 centre rows, a 37-row halo): T = 1 and T below
# the halo and below a tile, T a multiple of no tile and of a tile, B = 1
# and B = 3, and (2, 30000) with more tiles (150) than the card has SMs
K3_EDGES = [(1, 1), (3, 7), (1, 37), (3, 399), (1, 800), (3, 1001),
            (2, 30000)]


@pytest.mark.parametrize("b,t", [(2, 1000), (3, 801)] + K3_EDGES)
def test_k3_matches_plain_versions(cuda, b, t):
    """K3a with and without saving against its plain version (the logits
    without saving bitwise those with saving), K3b on K3a's streams
    against its plain version, bit-identical on a second run."""
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
    assert k3.fused_disc_backward.launches - n0 == k3.k3b_launches(True, True)
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


@pytest.mark.parametrize("b,t", [(2, 1000), (3, 801)] + K3_EDGES)
def test_k3c_matches_plain_version_and_k3b(cuda, b, t):
    """K3c against its plain version, and its dh bitwise K3b's on K3a's
    saved streams: K3c's rebuild and K3a run one forward routine.  (2,
    30000) has more tiles than the card has SMs, so a block walks
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
    assert (k3.fused_disc_backward_recompute.launches - n0
            == k3.k3c_launches(True, True))
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
    assert (k3.fused_disc_backward_recompute.launches - n0
            == k3.k3c_launches(True, False) + k3.k3c_launches(False, True))
    assert dx_only[1] is None and torch.equal(dx_only[0], grads[0])
    assert w_only[0] is None and torch.equal(w_only[1], grads[1])


def _k3_inputs(cuda, b, t, seed):
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    gen = torch.Generator().manual_seed(seed)
    kernels = [torch.randn((3, 64, 1 if j == 8 else 64), generator=gen)
               / 14 for j in range(9)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    wk, bk = (a.to(cuda) for a in k3.pack_disc_weights(kernels, biases))
    h = torch.randn((b, t, 64), generator=gen).to(cuda).to(torch.bfloat16)
    dlog = torch.randn((b, t), generator=gen).to(cuda)
    return wk, bk, h, dlog


# K3b's and K3c's edges: T below the receptive field (37) and below a
# tile, B = 3 with T a multiple of no tile (64, 208) or chunk, chunk
# boundaries inside an item (every case from B * T = 4133 on), more tiles
# and chunks than the card has SMs, and the recipe's shape at B = 4.
@pytest.mark.parametrize("b,t", [(3, 7), (2, 37), (3, 1001), (1, 4133),
                                 (5, 3000), (4, 20000)])
def test_k3b_k3c_edges_match_plain_versions(cuda, b, t):
    """Each of K3b and K3c within its tolerance of its plain version and
    bit-identical on a second run, dh-only and weights-only calls giving
    the full call's bits with their own launch counts, K3c's dh bitwise
    K3b's and its dW and db within K3C_VS_K3B_TOL of K3b's."""
    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    wk, bk, h, dlog = _k3_inputs(cuda, b, t, 7 * b + t)
    _, saved = k3.fused_disc_forward(h, wk, bk, slope=0.2, save=True)
    kw = dict(slope=0.2)
    for fn, args, count, full_n, dx_n, w_n in (
            (k3.fused_disc_backward, (saved, dlog, wk), k3.fused_disc_backward,
             k3.k3b_launches(True, True), k3.k3b_launches(True, False),
             k3.k3b_launches(False, True)),
            (k3.fused_disc_backward_recompute, (h, dlog, wk, bk),
             k3.fused_disc_backward_recompute, k3.k3c_launches(True, True),
             k3.k3c_launches(True, False), k3.k3c_launches(False, True))):
        n0 = count.launches
        grads = fn(*args, need_dx=True, need_weights=True, **kw)
        assert count.launches - n0 == full_n
        again = fn(*args, need_dx=True, need_weights=True, **kw)
        for name, g, a in zip(("dh", "dW", "db"), grads, again):
            assert torch.equal(g, a), f"{fn.__name__} {name} differs"
        n0 = count.launches
        dx_only = fn(*args, need_dx=True, need_weights=False, **kw)
        assert count.launches - n0 == dx_n
        n0 = count.launches
        w_only = fn(*args, need_dx=False, need_weights=True, **kw)
        assert count.launches - n0 == w_n
        assert dx_only[1:] == (None, None) and w_only[0] is None
        assert torch.equal(dx_only[0], grads[0])
        assert torch.equal(w_only[1], grads[1])
        assert torch.equal(w_only[2], grads[2])
        if fn is k3.fused_disc_backward:
            save_path = grads
            want = k3.disc_backward_reference(saved, dlog, wk, slope=0.2)
            for name, g, w in zip(("dh", "dW", "db"), grads, want):
                _hold(g, w, f"K3b {name}")
    want = k3.disc_backward_recompute_reference(h, dlog, wk, bk, slope=0.2)
    for name, g, w in zip(("dh", "dW", "db"), grads, want):
        assert torch.isfinite(g).all(), name
        rel = ((g - w).norm() / w.norm()).item()
        assert rel <= K3C_REL_L2, (name, rel)
    assert torch.equal(grads[0], save_path[0])
    for name, g, w in zip(("dW", "db"), grads[1:], save_path[1:]):
        err = (g - w).abs().max().item()
        assert err <= K3C_VS_K3B_TOL * w.abs().max().item(), (name, err)


def test_k3_shared_memory_matches_the_kernels(cuda):
    """The launcher's ``k3b_smem_bytes``, ``k3c_smem_bytes`` and
    ``k3a_smem_bytes`` are the kernels' own counts (``pwg_disc_smem``),
    within the card's 227 KB, and a K3a block fits an SM."""
    import ctypes

    from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
    from parakeet_tpu_torch.ops.kernels._build import load_library
    fn = load_library().cdll.pwg_disc_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    assert fn(0) == k3.k3b_smem_bytes() <= pwg_stack.SMEM_LIMIT
    assert fn(1) == k3.k3c_smem_bytes() <= pwg_stack.SMEM_LIMIT
    assert fn(2) == k3.k3a_smem_bytes() <= pwg_stack.SMEM_LIMIT
    assert k3.k3a_blocks_per_sm() == 1


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
            assert launched == ([1, k3.k3b_launches(True, True), 0]
                                if mode == "save"
                                else [0, 0, k3.k3c_launches(True, True)])
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
    (4, 4, 64, 64, 96, (64, 48, 57, 50), False),
    # Tk a multiple of neither key tile, Tq != Tk, masked query rows
    (2, 2, 130, 211, 64, (211, 100), False),
    # FastSpeech2's decoder self-attention (flash_sweep widths, 1024
    # frames) at a small batch, ragged key lengths
    (2, 4, 1024, 1024, 96, (1024, 731), False),
    # D = 80, padded to DP = 96 with zero columns; masked query rows
    (2, 2, 333, 333, 80, (333, 250), True),
    # the FastSpeech2 recipes' head width (adim 384 over 2 heads): K4a
    # with Q resident in shared memory, K4b split over two blocks a key
    # tile; masked query rows, then Tq != Tk
    (2, 2, 300, 300, 192, (300, 17), True),
    (2, 2, 130, 211, 192, (211, 100), False)])
def test_k4_matches_plain_versions(cuda, dtype, b, h, tq, tk, d,
                                   key_lengths, mask_rows):
    """K4a against the plain version unblocked and blocked at its own key
    tile (K4A_BLOCK_K), o and lse bit-identical on a second run; K4b and
    K4c against theirs."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    q, k, v, qv, kv, do = _k4_inputs(cuda, b, h, tq, tk, d, dtype,
                                     key_lengths, mask_rows, tq + d)
    if tq != tk:      # query rows masked as well: rows past tq // 2 of item 1
        qv = (torch.arange(tq, device=cuda)[None] < torch.tensor(
            [tq, tq // 2][:b], device=cuda)[:, None]).to(torch.int32)
    args, scale = (q, k, v, qv, kv), d ** -0.5
    n0 = k4.flash_attention_forward.launches
    o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
    assert k4.flash_attention_forward.launches - n0 == 1
    o2, lse2 = k4.flash_attention_forward(*args, sm_scale=scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    tol = K4_TOL[dtype]

    def hold(got, want, what):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), what
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (what, err)

    assert o.dtype == dtype and lse.dtype == torch.float32
    for block_k in (None, k4.K4A_BLOCK_K[dtype]):
        want_o, want_lse = k4.flash_attention_reference(
            *args, sm_scale=scale, block_k=block_k)
        hold(o, want_o, f"o, block_k={block_k}")
        hold(lse, want_lse, f"lse, block_k={block_k}")
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
    q, k, v, qv, kv, _ = _k4_inputs(cuda, 1, 1, 64, 64, 256, torch.float32,
                                    (64,), False, 0)
    with pytest.raises(NotImplementedError, match="K4"):
        k4.flash_attention_forward(q, k, v, qv, kv, sm_scale=1.0)
    x = torch.zeros((1, 64, 1, 256), device=cuda)
    with pytest.raises(NotImplementedError, match="K4"):
        make_flash_attn_core()(x, x, x)
    half = torch.zeros((1, 1, 64, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="K4"):
        k4.flash_attention_forward(half, half, half, qv, kv, sm_scale=1.0)
    q32 = torch.zeros((1, 1, 64, 32), device=cuda)
    with pytest.raises(ValueError, match="every tensor"):
        k4.flash_attention_forward(q32, q32, q32, qv.cpu(), kv,
                                   sm_scale=1.0)


# ---- captured programs: K1 and K4a inside a CUDA graph, the engine's grid
# of graphs and the streaming vocoder's window graph ----

def test_k1_and_k4a_inside_a_graph_give_the_eager_bits(cuda):
    """A graph of K1's 6 layers and one K4a launch replays the eager
    launches bit for bit; the wrappers count their launches while the
    program runs eagerly and is recorded, never at a replay."""
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    from parakeet_tpu_torch.utils.graphs import WARMUP_RUNS, CapturedProgram
    stack, gen = _stack(64, 80, layers=6, stacks=2, seed=3)
    stack = stack.to(cuda)
    kw = dict(dilations=stack.dilations(), stacks=2)
    x = torch.randn((2, 1000, 64), generator=gen).to(cuda)
    c = torch.randn((2, 1000, 80), generator=gen).to(cuda)
    q = torch.randn((2, 4, 300, 96), generator=gen).to(cuda, torch.bfloat16)
    valid = torch.ones((2, 300), dtype=torch.int32, device=cuda)

    def fn(x, c, q):
        out = pwg_stack.fused_residual_stack(x, c, stack.fused_weights(),
                                             **kw)
        o, _ = k4.flash_attention_forward(q, q, q, valid, valid,
                                          sm_scale=96 ** -0.5)
        return out + (o,)

    def counts():
        return (pwg_stack.fused_residual_stack.launches,
                k4.flash_attention_forward.launches)

    with torch.no_grad():
        want = fn(x, c, q)
        n0 = counts()
        prog = CapturedProgram(fn, {"x": x.clone(), "c": c.clone(),
                                    "q": q.clone()})
        n1 = counts()
        got = prog()
        got = prog()
    torch.cuda.synchronize()
    runs = WARMUP_RUNS + 1
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (6 * runs, runs)
    assert counts() == n1 and prog.replays == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_outputs_survive_other_graphs_of_the_pool(cuda):
    """Graphs on one pool reuse each other's scratch; each program's
    outputs are its own buffers, so replaying the others leaves them as
    its last replay wrote them."""
    from parakeet_tpu_torch.utils.graphs import CapturedProgram
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((4096, 256), generator=gen).to(cuda)

    def f(x):
        return (x * 2 + 1) @ x.T, x.sum(1)

    def g(x):
        return ((x - 3) * 5).exp().sum(0)

    first = CapturedProgram(f, {"x": x.clone()})
    others = [CapturedProgram(g, {"x": x.clone()}, pool=first.pool())
              for _ in range(3)]
    got = [t.clone() for t in first()]
    for p in others:
        p.inputs["x"].normal_()
        p()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first.outputs, got))
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(got, f(x)))


def _serving_models(cuda):
    from parakeet_tpu_torch.benchmarks.common import seeded_init_
    from parakeet_tpu_torch.models import FastSpeech2, PWGGenerator
    gen = torch.Generator().manual_seed(5)
    am = FastSpeech2(idim=40, odim=80, adim=64, aheads=2, elayers=2,
                     eunits=128, dlayers=2, dunits=128, postnet_chans=32,
                     duration_predictor_chans=32, pitch_predictor_chans=32,
                     energy_predictor_chans=32, dtype=torch.bfloat16)
    voc = PWGGenerator(layers=6, stacks=2, upsample_scales=(4, 5),
                       dtype=torch.bfloat16)
    seeded_init_(am, gen)
    seeded_init_(voc, gen)
    with torch.no_grad():
        am.duration_predictor.stack.linear.weight.mul_(0.25)
        am.duration_predictor.stack.linear.bias.fill_(1.1)
    return am.to(cuda).eval(), voc.to(cuda).eval()


def test_graph_engine_matches_the_eager_engine_bitwise(cuda):
    """One graph a grid point (the same kernels in the same order as the
    eager engine): every wav bit for bit, K1 once a layer a chunk in the
    replays (by the profiler); warm-up captures the full grid."""
    from parakeet_tpu_torch.ops.normalizer import ZScore
    from parakeet_tpu_torch.serving import Request, TTSEngine
    am, voc = _serving_models(cuda)
    norm = ZScore(torch.full((80,), -2.0), torch.full((80,), 1.5))
    grid = dict(text_buckets=(8, 16), batch_buckets=(1, 2, 4),
                frames_per_token=4, min_duration=1, am_norm=norm,
                voc_norm=norm)
    eager = TTSEngine(am, voc=voc, graphs=False, **grid)
    graphs = TTSEngine(am, voc=voc, **grid)
    assert graphs.graphs and graphs.am_norm.mu.is_cuda
    assert graphs.warmup() == 6
    gen = torch.Generator().manual_seed(9)
    reqs = [Request(ids=torch.randint(1, 40, (n,), generator=gen).tolist(),
                    utt_id=f"u{i}", seed=i)
            for i, n in enumerate((3, 8, 11, 16, 20, 5))]
    from parakeet_tpu_torch.benchmarks.common import (PROFILE_TRIES,
                                                      profiled_kernels)
    out = []
    kernels, _, _ = profiled_kernels(
        lambda: out.append(graphs.synthesize(reqs)))
    got, want = out[0], eager.synthesize(reqs)
    # two chunks: bucket 8 takes 3, 8, 5 and the 20-phone request's last
    # 4 phones, bucket 16 takes 11, 16 and its first 16; profiled_kernels
    # runs the batch PROFILE_TRIES times
    assert sum(p.replays for p in graphs._programs.values()) == (
        6 + 2 * PROFILE_TRIES)
    assert kernels == {"pwg_layer_kernel<64, false>": 6 * 2}
    for g, w in zip(got, want):
        assert g.n_frames == w.n_frames > 0
        assert np.array_equal(g.wav, w.wav), g.utt_id
    assert graphs.compiled_programs == 6


def test_streaming_on_the_card_replays_one_window_graph(cuda):
    """pwg_streaming_inference with the caller's window graph: a replay a
    window, bitwise the eager windows, and against one-shot pwg_inference
    within the tolerance chip_smoke states for it (K1's bf16 rounding,
    2^-5)."""
    from parakeet_tpu_torch.models.parallel_wavegan import (
        pwg_inference, pwg_streaming_inference, pwg_window_program)
    _, voc = _serving_models(cuda)
    gen = torch.Generator().manual_seed(4)
    mel = torch.randn((2, 150, 80), generator=gen).to(cuda)
    noise = torch.randn((2, 150 * 20, 1), generator=gen).to(cuda)
    prog = pwg_window_program(voc, mel, noise, chunk_frames=32)
    with torch.no_grad():
        full = pwg_inference(voc, mel, noise=noise)
        eager = pwg_streaming_inference(voc, mel, noise, chunk_frames=32)
        got = pwg_streaming_inference(voc, mel, noise, chunk_frames=32,
                                      program=prog)
    assert prog.replays == 5 and torch.equal(got, eager)
    tol = 2 ** -5 * full.float().abs().max().item()
    assert (got.float() - full.float()).abs().max().item() <= tol
