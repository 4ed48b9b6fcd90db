"""Kernel K2b's geometry (parakeet_tpu_torch/ops/kernels/pwg_stack_train.py),
which needs no card: the chunks of rows each block owns, each kernel's
shared memory, the launch count and the bytes each pass must move, and the
aux operand the kernels read.  The kernels themselves are held against
their plain version in tests/test_torch_cuda.py, on the card."""
import importlib.util
import pathlib

import pytest
import torch

from parakeet_tpu_torch.ops.kernels import pwg_stack as k1
from parakeet_tpu_torch.ops.kernels import pwg_stack_train as k2

ROOT = pathlib.Path(__file__).resolve().parents[1]
# B * T of the recipe's training step (8 x 25,500) and of the card tests
ROWS = [204_000, 2 * 1000, 333, 3 * 129, 3 * 700, 4133, 2 * 9001, 80_000,
        1, 7]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("sms", [132, 114])
def test_k2b_chunks_hold_every_row_once(rows, sms):
    """Every row lies in exactly one chunk, no chunk is empty, there are
    at most as many chunks as SMs (one block each), and the tiles of
    K2B_TILE_ROWS rows each block walks cover its chunk exactly: the
    conditions pwg_stack_bwd.cu's bad_chunks checks."""
    nparts, per = k2.k2b_chunks(rows, sms)
    assert 1 <= nparts <= sms
    assert nparts * per >= rows > (nparts - 1) * per
    owner = torch.full((rows,), -1)
    for i in range(nparts):
        qa, qb = i * per, min((i + 1) * per, rows)
        assert qb > qa
        tiles = [q for q0 in range(qa, qb, k2.K2B_TILE_ROWS)
                 for q in range(q0, min(q0 + k2.K2B_TILE_ROWS, qb))]
        assert tiles == list(range(qa, qb))
        assert (owner[qa:qb] == -1).all()
        owner[qa:qb] = i
    assert (owner >= 0).all()


@pytest.mark.parametrize("cr", [32, 64])
@pytest.mark.parametrize("ca", [13, 20, 80, 127])
def test_k2b_shared_memory_fits_a_block(cr, ca):
    """Every K2b kernel fits the H100's 227 KB of shared memory a block at
    each residual width and aux width the fused stack takes."""
    assert k1.fused_stack_supported(cr, 2 * cr, cr, 3, 30, 3, ca)
    smem = k2.k2b_smem_bytes(cr, ca)
    assert set(smem) == {"prep", "gate", "dw", "dx"}
    assert max(smem.values()) <= k2.SMEM_LIMIT == 227 * 1024


def test_k2b_shared_memory_at_the_recipe_widths():
    """The bytes pwg_stack_bwd.cu's gate_elems, dw_elems and dx_elems give
    at cr 64, ca 80 (KP 288, CAP 80), worked out by hand: the gate holds
    wg and wso (rows of 136) and two stages of the 64-row operand (pitch
    296) and dsk16 (72) plus dres and h; dw three stages of the operand
    and dg (136); dx the dx and dc weights and two stages of three dg
    tiles.  An aux width of 128 is not taken by the fused stack."""
    assert k2.k2b_smem_bytes(64, 80) == {
        "prep": 4096,
        "gate": 2 * (288 * 136 + 64 * 136 + 2 * 64 * (296 + 72)
                     + 2 * 64 * 72),
        "dw": 2 * 3 * 64 * (296 + 136),
        "dx": 2 * (384 * 72 + 128 * 88 + 2 * 3 * 64 * 136)}
    assert k2.k2b_smem_bytes(64, 80)["gate"] == 208_384
    assert not k1.fused_stack_supported(64, 128, 64, 3, 30, 3, 128)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k2b_launch_count_is_the_card_tests_and_chip_smokes():
    """One prep, gate and dx per layer, dw per layer with the weights, one
    reduction with them: what test_torch_cuda.py asserts per group and
    chip_smoke.py per training step (three groups of ten layers)."""
    assert k2.k2b_launches(10) == 32
    assert k2.k2b_launches(10, need_weights=False) == 21
    assert k2.k2b_launches(3) == 11
    smoke = _chip_smoke()
    cfg = smoke.PWG_CONFIG
    per = cfg["layers"] // cfg["stacks"]
    for disc_on in (False, True):
        assert smoke.expected_launches(disc_on)["K2b"] == (
            cfg["stacks"] * k2.k2b_launches(per))


def test_k2b_pass_bytes_at_the_record_shape():
    """About 2.9 KB a row and layer at cr 64, ca 80 and 3.1 KB with the
    chunks' weight-gradient partials and their reduction, the figures
    pwg_stack_bwd.cu's header states: gate 928 bytes, dw 544, dx 1,408
    (1,088 in the first layer, which writes dc without reading it);
    without the weight gradients dw and the reduction go and the gate
    writes no partials."""
    b, t, layers = 8, 25_500, 10
    rows = b * t
    chunks = k2.k2b_chunks(rows, 132)[0]
    got = k2.k2b_pass_bytes(b, t, 64, 80, layers, chunks)
    part = chunks * 65 * 128 * 4
    assert got["gate"] == layers * (rows * 928 + part)
    assert got["dw"] == layers * (rows * 544 + chunks * 288 * 128 * 4)
    assert got["dx"] == layers * rows * 1408 - rows * 320
    per_row = sum(got.values()) / (rows * layers)
    assert 3_050 < per_row < 3_200
    lean = k2.k2b_pass_bytes(b, t, 64, 80, layers, chunks,
                             need_weights=False)
    assert set(lean) == {"prep", "gate", "dx"}
    assert lean["gate"] == layers * rows * 928
    assert lean["dx"] == got["dx"]
    assert 2_850 < (sum(lean.values()) + layers * rows * 544) / (
        rows * layers) < 2_950


@pytest.mark.parametrize("ca", [80, 16, 13, 20, 1])
def test_k2b_aux_rows(ca):
    """Where c's rows are 16-byte vectors the kernels read c itself and
    add the 1 and the zeros; elsewhere the [c | 1 | 0] operand in bf16."""
    cr = 64
    kp = 3 * cr + -(-(ca + 1) // 16) * 16
    gen = torch.Generator().manual_seed(ca)
    c16 = torch.randn((2, 5, ca), generator=gen).to(torch.bfloat16)
    c_op, cw = k2.aux_rows(c16, kp, cr)
    if ca % 8 == 0:
        assert c_op is c16 and cw == ca
        return
    assert cw == kp - 3 * cr and c_op.dtype == torch.bfloat16
    assert c_op.is_contiguous() and c_op.shape == (2, 5, cw)
    assert torch.equal(c_op[..., :ca], c16)
    assert (c_op[..., ca] == 1).all() and (c_op[..., ca + 1:] == 0).all()
    assert torch.equal(c_op.float(), k1.aux_operand(c16, kp, cr))
