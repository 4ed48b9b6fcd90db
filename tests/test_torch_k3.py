"""Kernels K3b and K3c's geometry and launcher (parakeet_tpu_torch/ops/
kernels/pwg_disc.py), which need no card: the chunks of tiles each K3b
block owns, each kernel's shared memory, the launch counts, the bytes a
call moves, the buffers K3c keeps, and the arguments of each K3b launch.
The kernels themselves are held against their plain versions in
tests/test_torch_cuda.py, on the card."""
import importlib.util
import pathlib

import pytest
import torch

from parakeet_tpu_torch.ops.kernels import pwg_disc as k3
from parakeet_tpu_torch.ops.kernels.pwg_stack import SMEM_LIMIT

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (B, T) of the recipe's training step and of the card tests
SHAPES = [(8, 25_500), (4, 20_000), (3, 7), (2, 37), (3, 1001), (1, 4133),
          (5, 3000), (2, 30_000), (1, 1), (1, 64), (2, 65)]


@pytest.mark.parametrize("b,t", SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_k3b_chunks_hold_every_row_once(b, t, sms):
    """The tiles of K3B_TILE_ROWS rows of one item, in (item, time) order,
    cut into at most ``sms`` contiguous chunks, none empty, hold every
    row of every item exactly once: the conditions pwg_disc_bwd_layer
    checks."""
    nchunk, per = k3.k3b_chunks(b, t, sms)
    tm = k3.K3B_TILE_ROWS
    tpi = -(-t // tm)
    tiles = b * tpi
    assert 1 <= nchunk <= sms
    assert nchunk * per >= tiles > (nchunk - 1) * per
    owner = torch.full((b, t), -1)
    for c in range(nchunk):
        ga, gb = c * per, min((c + 1) * per, tiles)
        assert gb > ga
        for g in range(ga, gb):
            item, t0 = divmod(g, tpi)
            rows = owner[item, t0 * tm:min(t0 * tm + tm, t)]
            assert rows.numel() > 0 and (rows == -1).all()
            rows[:] = c
    assert (owner >= 0).all()


def test_k3_shared_memory_by_hand():
    """pwg_disc.cu's kLayerSmem and kRcSmem, worked out by hand.  K3b: the
    layer's 192 weight rows of 72 bf16, four stages of the tile's dpre and
    saved rows (64 + 2 * 8 rows of 72 bf16 each) and dlogits (80 float32),
    and 320 float32 of db sums.  K3c (TCR = 272): the recompute half's two
    windows of 448 rows of 80 bf16, one layer's weights, the wmma staging
    (8 warps x 16 rows x 68 float32) and the bias, against the reverse
    half's two windows of 368 rows, two layers' weights and the dW
    operand's 288 rows of 72; then db (9 + 8 rows of 64 float32)."""
    weights = 192 * 72 * 2
    stage = 2 * 80 * 72 * 2 + 80 * 4
    assert k3.k3b_smem_bytes() == weights + 4 * stage + 4 * 320 == 122_368
    assert k3.K3C_TILE_ROWS == 272
    fwd = 2 * 448 * 80 * 2 + weights + 8 * 16 * 68 * 4 + 64 * 4
    rev = 2 * 368 * 80 * 2 + 2 * weights + 288 * 72 * 2
    assert (fwd, rev) == (206_080, 214_528)
    assert k3.k3c_smem_bytes() == rev + 17 * 64 * 4 == 218_880
    assert max(k3.k3b_smem_bytes(), k3.k3c_smem_bytes()) <= SMEM_LIMIT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_launch_counts_are_the_card_tests_and_chip_smokes():
    """K3b: a pass per layer and one reduction with the weights; K3c: the
    kernel and one reduction with the weights; nothing when nothing is
    asked for.  A GAN step runs the discriminator's backward once for the
    generator's input gradient and twice (real, fake) with the weights."""
    assert k3.k3b_launches(True, True) == 10
    assert k3.k3b_launches(True, False) == 9
    assert k3.k3b_launches(False, True) == 10
    assert k3.k3b_launches(False, False) == 0
    assert k3.k3c_launches(True, True) == 2
    assert k3.k3c_launches(True, False) == k3.k3c_launches(False, True) - 1
    assert k3.k3c_launches(False, False) == 0
    smoke = _chip_smoke()
    save = smoke.expected_launches(True, "save")
    rc = smoke.expected_launches(True, "recompute")
    assert (save["K3b"], save["K3c"]) == (9 + 2 * 10, 0)
    assert (rc["K3b"], rc["K3c"]) == (0, 1 + 2 * 2)
    off = smoke.expected_launches(False, "save")
    assert off["K3b"] == off["K3c"] == off["K3a"] == 0


def test_k3b_bytes_at_the_record_shape():
    """The hand count at B=8, T=25,500 (204,000 rows): pass 8 reads
    dlogits (4 bytes a row) and x_8 (128) and writes dpre_7 (128); passes
    7..1 read dpre_j and x_j and write dpre_j-1 (384); pass 0 reads dpre_0
    and x_0 and writes dh (512): 3,460 bytes a row, 0.706 GB, plus the
    weights once and each of 128 chunks' (9, 193, 64) float32 partials,
    written and read by the reduction.  A dh-only call skips x_0 and the
    partials."""
    b, t = 8, 25_500
    rows = b * t
    weights = 9 * 3 * 64 * 64 * 2
    part = 9 * 193 * 64 * 4
    assert k3.k3b_chunks(b, t, 132) == (128, 25)
    got = k3.k3b_bytes(b, t)
    assert got == {"layers": rows * 3_460 + weights + 128 * part,
                   "reduce": 128 * part + part}
    assert 0.70e9 < rows * 3_460 < 0.71e9
    assert k3.k3b_bytes(b, t, need_weights=False) == {
        "layers": rows * (3_460 - 128) + weights}


def test_k3c_buffers_and_bytes_at_the_record_shape():
    """K3c at B=8, T=25,500 on 132 SMs: 752 tiles of 272 rows over 132
    blocks.  Each block keeps a (9, 193, 64) float32 partial (58.7 MB in
    all) and nine streams of 352 reverse-window rows (53.5 MB): 112.2 MB,
    over the H100's 50 MB of L2, as the 102.5 MB of TCR = 208 were.  The
    budget the design chose is the partials' read-modify-write per row: a
    tile's nine (192, 64) float32 blocks read and written serve 272 rows,
    3.25 KB a row against 4.25 KB at 208.  Per tile the kernel also
    writes the 352 rows of the nine streams, reads back those of streams
    1..8 for the masks and 288 rows of each stream for dW, and skips the
    partial's read on a block's first tile."""
    b, t = 8, 25_500
    rows, tiles, blocks = b * t, 8 * 94, 132
    assert k3.k3c_blocks(b, t, 132) == blocks and tiles > blocks
    held = k3.k3c_buffer_bytes(b, t)
    assert held == {"partials": blocks * 9 * 193 * 64 * 4,
                    "scratch": blocks * 9 * 352 * 64 * 2}
    assert 112e6 < sum(held.values()) < 113e6
    dw = 9 * 192 * 64 * 4
    assert 2 * dw / 272 < 3_300 < 4_200 < 2 * dw / 208
    kernel = (rows * (128 + 4 + 256) + tiles * 17 * 352 * 128
              + blocks * 2 * 9 * 3 * 64 * 64 * 2
              + tiles * (9 * 288 * 128 + 2 * dw) - blocks * dw
              + blocks * 9 * 64 * 4)
    part = 9 * 193 * 64 * 4
    assert k3.k3c_bytes(b, t) == {"kernel": kernel,
                                  "reduce": blocks * part + part}
    assert k3.k3c_blocks(1, 7, 132) == 1


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), name
            self.calls.append((name, args))
            return 0
        return fn


@pytest.mark.parametrize("need_dx,need_weights", [(True, True),
                                                  (True, False),
                                                  (False, True)])
def test_k3b_launches_one_pass_a_layer(monkeypatch, need_dx, need_weights):
    """``_disc_backward_cuda`` launches layers 8 down to 0: pass 8 reads
    dlogits, every other pass the dpre its successor wrote, dpre
    ping-pongs between two streams, only pass 0 writes dh, x_0 is read
    only for dW, and every pass writes the same partials, which one
    reduction then sums over the chunks."""
    rec = _Recorder()
    monkeypatch.setattr(k3, "kernel_call", rec)

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    b, t, sms = 2, 300, 4
    saved = torch.zeros((9, b, t, 64), dtype=torch.bfloat16)
    dlog = torch.zeros((b, t))
    wk = torch.zeros((9, 3, 64, 64))
    n0 = k3.fused_disc_backward.launches
    dx, dwk, dbk = k3._disc_backward_cuda(saved, dlog, wk, 0.2, need_dx,
                                          need_weights, sms)
    calls = rec.calls
    assert k3.fused_disc_backward.launches - n0 == len(calls) == (
        k3.k3b_launches(need_dx, need_weights))
    nchunk, per = k3.k3b_chunks(b, t, sms)
    layers = [args for name, args in calls if name == "pwg_disc_bwd_layer"]
    assert len(layers) == 9
    outs = []
    for i, (xj, dpj, dl, wkt, dp_out, dxp, part, *ints, slope, stream) in (
            enumerate(layers)):
        j = 8 - i
        assert ints == [j, b, t, nchunk, per] and stream == 1234
        assert slope == pytest.approx(0.2)
        want_x = saved[j].data_ptr() if j > 0 or need_weights else None
        assert xj == want_x
        assert (dl is not None) == (j == 8) and (dpj is None) == (j == 8)
        assert (dp_out is None) == (j == 0)
        if j < 8:
            assert dpj == outs[-1]
        outs.append(dp_out)
        assert dxp == (dx.data_ptr() if j == 0 and need_dx else None)
        assert (part is None) != need_weights
        assert part == layers[0][6]
        if j < 8:
            assert wkt - layers[i - 1][3] == -192 * 64 * 2
    assert len(set(outs[:-1])) == 2
    if need_weights:
        name, (part, out, n, numel, stream) = calls[-1]
        assert name == "pwg_reduce_partials"
        assert (part, n, numel) == (layers[0][6], nchunk, 9 * 193 * 64)
        assert dwk.shape == (9, 3, 64, 64) and dbk.shape == (9, 64)
        assert dwk.data_ptr() == out and dbk.data_ptr() == out + 192 * 64 * 4
    else:
        assert dwk is None and dbk is None
    assert (dx is not None) == need_dx
