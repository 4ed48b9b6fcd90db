"""Kernels K3a, K3b and K3c's geometry and launcher (parakeet_tpu_torch/
ops/kernels/pwg_disc.py), which need no card: the strips each layer of
the forward computes and K3a as it tiles the rows, in plain PyTorch,
against the untiled plain version bit for bit; the chunks of tiles each
K3b block owns, each kernel's shared memory, the launch counts, the bytes
a call moves, the buffers K3c keeps, and the arguments of each K3b
launch.  The kernels themselves are held against their plain versions in
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
    """pwg_disc.cu's kFwdSmem, kLayerSmem and kRcSmem, worked out by hand.
    K3a: a window of 485 rows of 72 bf16 and one layer's 192 weight rows
    of 72 bf16, then the larger of the second window and weights and the
    float32 window staged over them (485 rows of 64 float32), and the nine
    layers' biases (576 float32).  K3b: the
    layer's weights, four stages of the tile's dpre and saved rows (64 + 2
    * 8 rows of 72 bf16 each) and dlogits (80 float32), and 320 float32 of
    db sums.  K3c (TCR = 272): the recompute half's two windows of 441
    rows of 72 bf16, two layers' weights and the biases of layers 0..7,
    against the reverse half's two windows of 368 rows of 80, two layers'
    weights and the dW operand's 288 rows of 72; then db (9 + 8 rows of 64
    float32)."""
    weights = 192 * 72 * 2
    window = 485 * 72 * 2
    assert window + weights == 97_488 < 485 * 64 * 4 == 124_160
    assert k3.k3a_smem_bytes() == (window + weights + 124_160
                                   + 9 * 64 * 4) == 223_952
    stage = 2 * 80 * 72 * 2 + 80 * 4
    assert k3.k3b_smem_bytes() == weights + 4 * stage + 4 * 320 == 122_368
    assert k3.K3C_TILE_ROWS == 272
    fwd = 2 * 441 * 72 * 2 + 2 * weights + 8 * 64 * 4
    rev = 2 * 368 * 80 * 2 + 2 * weights + 288 * 72 * 2
    assert (fwd, rev) == (184_352, 214_528)
    assert k3.k3c_smem_bytes() == rev + 17 * 64 * 4 == 218_880
    assert max(k3.k3a_smem_bytes(), k3.k3b_smem_bytes(),
               k3.k3c_smem_bytes()) <= SMEM_LIMIT


def test_forward_strips_by_hand():
    """The strips of 16 rows the forward-layer routine computes.  K3a
    (TC = 400, RF = 37): rows 36 .. 437 of x_8 are wanted (the centre and
    the output conv's taps), so layer j's output is wanted on those and
    the dilations of layers j + 1 .. 7 on each side (35, 33, 30, 26, 21,
    15, 8, 0 rows): 472, 468, 462, 454, 444, 432, 418 and 402 rows, in
    30, 30, 29, 29, 28, 27, 27 and 26 strips.  Layer 1 reads furthest,
    rows 1 .. 484, in a window of 485 rows.  With the output conv's 25
    strips on one n8 tile, 1.14x the useful products.  K3c's rebuild
    (TCR = 272) keeps the reverse window's 352 rows from row 40 exact on
    a window of 441 rows, which holds the 432 rows of its halo."""
    strips = k3.forward_strips(402, 36)
    assert strips == [(1, 30), (3, 30), (6, 29), (10, 29), (15, 28),
                      (21, 27), (28, 27), (36, 26)]
    assert k3.forward_window_rows(402, 36) == 485
    assert [lo - d for (lo, _), d in zip(strips, k3.DISC_TAIL_DILS)] == [
        0, 1, 3, 6, 10, 15, 21, 28]
    assert max(lo + 16 * n + d for (lo, n), d in zip(
        strips, k3.DISC_TAIL_DILS)) == 485
    computed = 64 * 16 * sum(n for _, n in strips) + 8 * 400
    useful = 64 * 8 * 400 + 400
    assert 1.14 < computed / useful < 1.15
    assert k3.forward_strips(352, 40) == [
        (5, 27), (7, 27), (10, 26), (14, 26), (19, 25), (25, 24), (32, 23),
        (40, 22)]
    assert k3.forward_window_rows(352, 40) == 441 >= 272 + 2 * 80
    assert k3.K3C_REBUILD_FIRST == 40 and k3.K3A_HALO == 37


def test_k3a_grid_and_bytes_at_the_record_shape():
    """K3a at B=8, T=25,500: 64 blocks an item (the last holds 300 centre
    rows), 512 blocks, 3.88 waves of one block an SM on 132 SMs.  A call
    with saving reads h in float32 (256 bytes a row) and writes the
    logits (4) and the nine bf16 streams (1,152): 1,412 bytes a row, 0.288
    GB; the weights and biases once.  Without saving: 260 bytes a row."""
    b, t = 8, 25_500
    rows = b * t
    assert k3.k3a_grid(b, t) == 512 and k3.k3a_grid(1, 7) == 1
    once = 9 * (3 * 64 * 64 * 2 + 64 * 4)
    assert k3.k3a_bytes(b, t) == rows * 1_412 + once
    assert k3.k3a_bytes(b, t, save=False) == rows * 260 + once
    assert 0.28e9 < k3.k3a_bytes(b, t) < 0.29e9


def _forward_window(x, w, bk, slope, tw0, rows, first):
    """pwg_disc.cu's ``forward_layer`` for layers 0..7 on one window of one
    item's bf16 rows x (T, 64), window row r being time tw0 + r: the
    window loaded with zeros outside the item, the second one filled with
    NaN (so that a row no layer wrote, read where it counts, shows), each
    layer computing its ``forward_strips`` rows from the rows +- d of the
    other buffer.  Returns the windows of x_0 .. x_8."""
    t = x.shape[0]
    xa = k3.forward_window_rows(rows, first)
    tw = torch.arange(xa) + tw0
    inside = (tw >= 0) & (tw < t)
    cur = torch.zeros((xa, 64))
    cur[inside] = x[tw[inside]]
    nxt = torch.full((xa, 64), float("nan"))
    wins = [cur.clone()]
    for j, (lo, n) in enumerate(k3.forward_strips(rows, first)):
        d = k3.DISC_TAIL_DILS[j]
        r = torch.arange(lo, lo + 16 * n)
        assert lo - d >= 0 and lo + 16 * n + d <= xa
        pre = (cur[r - d] @ w[j, 0] + cur[r] @ w[j, 1] + cur[r + d] @ w[j, 2]
               + bk[j])
        y = torch.where(pre > 0, pre, slope * pre).to(torch.bfloat16).float()
        nxt[r] = torch.where(inside[r, None], y, torch.zeros(()))
        cur, nxt = nxt, cur
        wins.append(cur.clone())
    return wins


def _k3a_tiled(h, wk, bk, slope, tc):
    """K3a as the kernel cuts the rows: a window per TC centre rows of an
    item, layers 0..7 by ``_forward_window``, the output conv on the
    centre's strips and the first 8 columns only."""
    b, t, _ = h.shape
    rf = k3.K3A_HALO
    x = h.to(torch.bfloat16).float()
    w = wk.to(torch.bfloat16).float()
    logits = torch.full((b, t), float("nan"))
    saved = torch.full((9, b, t, 64), float("nan"))
    for item in range(b):
        for t0 in range(0, t, tc):
            n = min(tc, t - t0)
            wins = _forward_window(x[item], w, bk, slope, t0 - rf, tc + 2,
                                   rf - 1)
            for j, win in enumerate(wins):
                saved[j, item, t0:t0 + n] = win[rf:rf + n]
            r = torch.arange(rf, rf + tc)
            cur = wins[-1]
            pre = (cur[r - 1] @ w[8, 0, :, :8] + cur[r] @ w[8, 1, :, :8]
                   + cur[r + 1] @ w[8, 2, :, :8] + bk[8, :8])
            logits[item, t0:t0 + n] = pre[:n, 0]
    return logits, saved


def _disc_weights(seed):
    gen = torch.Generator().manual_seed(seed)
    kernels = [torch.randn((3, 64, 1 if j == 8 else 64), generator=gen)
               / 14 for j in range(9)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    return (*k3.pack_disc_weights(kernels, biases), gen)


# T below the receptive field and below a tile, T a multiple of no tile,
# a whole number of tiles, B = 1 and B = 3; tc 48 cuts more tiles
@pytest.mark.parametrize("b,t,tc", [(1, 1, 400), (3, 7, 400),
                                    (1, 37, 400), (3, 399, 400),
                                    (1, 800, 400), (3, 1001, 400),
                                    (2, 301, 48)])
def test_k3a_tiled_equals_the_plain_version_bitwise(b, t, tc):
    """K3a tile by tile (``_k3a_tiled``, the halo arithmetic of
    ``forward_strips`` and ``forward_window_rows``) gives the logits and
    the nine saved streams of ``disc_forward_reference`` bit for bit: the
    centre rows are exact, the halo rows and rows past the item reach
    nothing they should not, and the output conv's column 0 does not
    depend on columns 8..63 (which are zero in the packed weights)."""
    wk, bk, gen = _disc_weights(b * t + tc)
    h = torch.randn((b, t, 64), generator=gen)
    logits, saved = _k3a_tiled(h, wk, bk, 0.2, tc)
    want_logits, want_saved = k3.disc_forward_reference(h, wk, bk,
                                                        slope=0.2)
    assert torch.equal(saved, want_saved.float())
    assert torch.equal(logits, want_logits)


@pytest.mark.parametrize("b,t", [(1, 7), (3, 300), (2, 1001)])
def test_k3c_rebuild_equals_the_plain_streams_bitwise(b, t):
    """K3c's rebuild as the kernel tiles it (TCR centre rows, window row r
    at time t0 - 80 + r, ``forward_strips`` keeping the 352-row reverse
    window from row 40 exact) gives each stream's reverse-window rows as
    ``disc_forward_reference`` saves them, zero outside the item: what
    makes K3c's dh K3b's bit for bit."""
    wk, bk, gen = _disc_weights(7 * b + t)
    h = torch.randn((b, t, 64), generator=gen)
    _, want = k3.disc_forward_reference(h, wk, bk, slope=0.2)
    x = h.to(torch.bfloat16).float()
    w = wk.to(torch.bfloat16).float()
    tcr, first, halo = k3.K3C_TILE_ROWS, k3.K3C_REBUILD_FIRST, 40
    wr = tcr + 2 * halo            # the reverse window, from t0 - 40
    padded = torch.zeros((9, b, t + 2 * wr, 64))
    padded[:, :, wr:wr + t] = want.float()
    for item in range(b):
        for t0 in range(0, t, tcr):
            wins = _forward_window(x[item], w, bk, 0.2, t0 - halo - first,
                                   wr, first)
            for j, win in enumerate(wins):
                ref = padded[j, item, wr + t0 - halo:wr + t0 - halo + wr]
                assert torch.equal(win[first:first + wr], ref), (j, t0)


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
