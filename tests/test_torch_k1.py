"""Kernels K1 and K2a's geometry and launcher (parakeet_tpu_torch/ops/
kernels/pwg_stack.py), which need no card: the warps and shared memory of
a block, the bytes a call must move with one layer per launch, the
arguments of each launch, and the kernel names chip_smoke.py reports.  The
kernels themselves are held against their plain version in
tests/test_torch_cuda.py, on the card."""
import importlib.util
import pathlib

import pytest
import torch

from parakeet_tpu_torch.ops.kernels import pwg_stack as k1

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("cr", [32, 64, 128])
@pytest.mark.parametrize("ca", [13, 20, 80, 95, 96, 127])
def test_k1_shared_memory_fits_a_block(cr, ca):
    """A K1/K2a block fits the H100's 227 KB at every residual and aux
    width the fused stack takes: eight warps, each with its 16-row stage,
    except at cr 64 with ca >= 96, where seven stages fit beside the
    wider weights; at cr 128 the gate launch (half of wg's columns, a
    stage of bf16 gate operand rows a warp) has eight warps at aux
    operands of up to 48 columns, six at 96 and 112 and five at 128, and
    the output launch eight."""
    assert k1.fused_stack_supported(cr, 2 * cr, cr, 3, 30, 3, ca)
    assert k1.k1_smem_bytes(cr, ca) <= k1.SMEM_LIMIT == 227 * 1024
    wide = {13: 8, 20: 8, 80: 6, 95: 6, 96: 6, 127: 5}
    want = {32: 8, 64: 7 if ca >= 96 else 8, 128: wide[ca]}
    assert k1.k1_warps(cr, ca) == want[cr]
    assert k1.K1_OUT_SMEM <= k1.SMEM_LIMIT


def test_k1_shared_memory_at_every_aux_width():
    for cr in (32, 64, 128):
        for ca in range(1, 128):
            assert k1.k1_smem_bytes(cr, ca) <= k1.SMEM_LIMIT, (cr, ca)
            assert k1.k1_warps(cr, ca) >= (5 if cr == 128 else 7), (cr, ca)


def test_k1_shared_memory_at_residual_width_128():
    """pwg_stack_cr128.cu's geometry at cr 128, ca 80 (KP 480, [c | 1 | 0]
    96 wide), worked out by hand: the gate launch holds its half of wg's
    columns (64 tanh, 64 sigmoid) in rows of 136 bf16, 130,560 bytes, and
    a warp's stage of 16 rows of the bf16 gate operand (rows of 488),
    15,616 bytes: six of them, as a seventh would need 239,872; the
    output launch holds wso in rows of 264 bf16 and bso, 68,608 bytes,
    and eight stages of 16 rows of h (rows of 136 bf16)."""
    weights, stage = 2 * 480 * 136, 16 * 2 * 488
    assert (weights, stage) == (130_560, 15_616)
    assert weights + 7 * stage == 239_872 > k1.SMEM_LIMIT
    assert k1.k1_warps(128, 80) == 6
    assert k1.k1_smem_bytes(128, 80) == weights + 6 * stage == 224_256
    out = 2 * 128 * 264 + 4 * 256 + 8 * 16 * 2 * 136
    assert k1.K1_OUT_SMEM == out == 103_424
    assert k1.k1_layer_launches(128) == 2
    assert k1.k1_layer_launches(64) == k1.k1_layer_launches(32) == 1


def test_k1_shared_memory_at_the_recipe_widths():
    """pwg_stack.cu's Geometry at cr 64, ca 80 (KP 288, [c | 1 | 0] 96
    wide), worked out by hand: wg and wso in rows of 136 bf16 and bso,
    95,744 + 512 bytes; a warp's stage of 16 rows holds the float32 taps
    in rows of 200 and the aux columns in rows of 104 bf16, 16,128 bytes;
    eight of them."""
    weights = 2 * (288 + 64) * 136 + 4 * 128
    stage = 16 * (4 * 200 + 2 * 104)
    assert (weights, stage) == (96_256, 16_128)
    assert k1.k1_smem_bytes(64, 80) == weights + 8 * stage == 225_280
    # seven warps at the widest aux operand: eight would need 242,176
    wide = 2 * (320 + 64) * 136 + 512
    assert wide + 8 * 16 * (800 + 272) > k1.SMEM_LIMIT
    assert k1.k1_smem_bytes(64, 127) == wide + 7 * 16 * (800 + 272)


def test_k1_layer_bytes_at_the_record_shapes():
    """The hand count: per row and layer x read in float32 (256 bytes), c
    in bf16 (160), the skip sum read and written (512) and x_next written
    (256), 1,184 bytes; K2a also writes the bf16 input rows (128), 1,312.
    K1's first layer writes the skip sum without reading it and its last
    writes x in bf16; each K2a group starts its own skip sum."""
    serving = k1.k1_layer_bytes(1, 268_800, 64, 80, 30, 3, save=False)
    assert serving == 268_800 * (30 * 1_184 - 256 - 128) == 9_444_556_800
    assert 9.44e9 < serving < 9.45e9
    group = k1.k1_layer_bytes(8, 25_500, 64, 80, 10, 1, save=True)
    assert group == 204_000 * (10 * 1_312 - 256) == 2_624_256_000
    assert 2.62e9 < group < 2.63e9
    # three groups are three calls: three starts of the skip sum
    assert k1.k1_layer_bytes(8, 25_500, 64, 80, 30, 3, save=True) == 3 * group


def test_k1_layer_bytes_at_residual_width_128():
    """At cr 128 a layer's two launches move, a row: the gate reads x's
    taps in bf16 (256) and c (160) and writes h (256); the output launch
    reads h (256), x in float32 (512) and the skip sum (512) and writes
    the skip sum (512), x_next (512) and x_next in bf16 (256: the next
    layer's taps, in K2a its saved rows), 3,232 bytes.  A call's first
    layer reads no skip sum, its last writes no bf16 copy (and in K1 its
    x_next in bf16 only)."""
    serving = k1.k1_layer_bytes(1, 268_800, 128, 80, 30, 3, save=False)
    assert serving == 268_800 * (30 * 3_232 - 512 - 256 - 256)
    assert serving == 25_787_596_800
    group = k1.k1_layer_bytes(8, 25_500, 128, 80, 10, 1, save=True)
    assert group == 204_000 * (10 * 3_232 - 512 - 256) == 6_436_608_000


@pytest.mark.parametrize("ca", [13, 20, 100])
def test_k1_layer_bytes_read_the_aux_operand(ca):
    """Where ca % 8 != 0 the kernel reads the [c | 1 | 0] operand of
    ``aux_rows``, whose width is ca + 1 rounded up to 16."""
    aw = -(-(ca + 1) // 16) * 16
    cw = ca if ca % 8 == 0 else aw
    got = k1.k1_layer_bytes(2, 100, 32, ca, 6, 2, save=False)
    assert got == 200 * (6 * (32 * 16 + cw * 2) - 128 - 64)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("ca", [80, 13])
@pytest.mark.parametrize("save", [False, True])
def test_k1_launches_one_layer_at_a_time(monkeypatch, ca, save):
    """``_run_layers`` launches each layer once: x ping-pongs between two
    float32 buffers, the first layer starts the skip sum, every group end
    rounds x, only the last layer writes the caller's output (bf16 at the
    stack's end), K2a saves each layer's input, and c is handed over as
    ``aux_rows`` gives it, with its width."""
    rec = _Recorder()
    monkeypatch.setattr(k1, "kernel_call", lambda name, args: rec)

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    b, t, cr, n, per = 2, 9, 32, 6, 3
    kp = 3 * cr + -(-(ca + 1) // 16) * 16
    x = torch.zeros((b, t, cr))
    c16 = torch.zeros((b, t, ca), dtype=torch.bfloat16)
    wg = torch.zeros((n, kp, 2 * cr), dtype=torch.bfloat16)
    wso = torch.zeros((n, cr, 2 * cr), dtype=torch.bfloat16)
    bso = torch.zeros((n, 2 * cr))
    out = torch.empty((b, t, cr), dtype=torch.float32 if save
                      else torch.bfloat16)
    saved = torch.empty((n, b, t, cr), dtype=torch.bfloat16) if save else None
    counter = type("Counter", (), {"launches": 0})
    skip = k1._run_layers(x, c16, wg, wso, bso, [1, 2, 4] * 2, per=per,
                          out=out, saved=saved, counter=counter)
    assert counter.launches == n == len(rec.calls)
    assert skip.shape == (b, t, cr) and skip.dtype == torch.float32
    ins = [call[0] for call in rec.calls]
    assert ins[0] == x.data_ptr() and len(set(ins)) == 2
    for i, call in enumerate(rec.calls):
        (x_in, x_f32, x_bf16, c_ptr, wg_p, wso_p, bso_p, skip_p, saved_p,
         *ints, stream) = call
        assert stream == 1234
        assert (wg_p, wso_p, bso_p) == (wg[i].data_ptr(), wso[i].data_ptr(),
                                        bso[i].data_ptr())
        assert skip_p == skip.data_ptr()
        assert saved_p == (saved[i].data_ptr() if save else None)
        last = i == n - 1
        dst = out.data_ptr() if last else ins[i + 1]
        assert (x_f32, x_bf16) == ((dst, None) if save or not last
                                   else (None, dst))
        cw = ca if ca % 8 == 0 else kp - 3 * cr
        if ca % 8 == 0:
            assert c_ptr == c16.data_ptr()
        else:
            assert c_ptr != c16.data_ptr()
        assert ints == [b, t, cr, ca, cw, kp, [1, 2, 4][i % 3], int(i == 0),
                        int((i + 1) % per == 0)]
    assert len(k1._LAYER_ARGS) == len(rec.calls[0])


@pytest.mark.parametrize("save", [False, True])
def test_k1_launches_two_kernels_a_layer_at_128(monkeypatch, save):
    """At cr 128 ``_run_layers`` launches the gate kernel, which writes h,
    and then the output kernel, which reads it, for each layer: x
    ping-pongs as at the other widths, the first layer starts the skip
    sum, group ends round x, only the last layer writes the caller's
    output, and each launch counts once.  The gate reads the layer's
    input in bf16: the caller's x16 first (K1), or saved[0] filled from x
    (K2a); each output launch but the last writes the next one's (K2a:
    into saved[i + 1]; K1: in place, into a buffer of its own)."""
    calls = []

    def kernel_call(name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(k1, "kernel_call", kernel_call)

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    b, t, cr, ca, n, per = 2, 9, 128, 80, 4, 2
    kp = 3 * cr + 96
    x = torch.zeros((b, t, cr))
    c16 = torch.zeros((b, t, ca), dtype=torch.bfloat16)
    wg = torch.zeros((n, kp, 2 * cr), dtype=torch.bfloat16)
    wso = torch.zeros((n, cr, 2 * cr), dtype=torch.bfloat16)
    bso = torch.zeros((n, 2 * cr))
    out = torch.empty((b, t, cr), dtype=torch.float32 if save
                      else torch.bfloat16)
    saved = torch.empty((n, b, t, cr), dtype=torch.bfloat16) if save else None
    x.normal_(generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16).float()
    x16 = x.to(torch.bfloat16)
    counter = type("Counter", (), {"launches": 0})
    skip = k1._run_layers(x.clone(), c16, wg, wso, bso, [1, 2] * 2, per=per,
                          out=out, saved=saved, counter=counter,
                          x16=None if save else x16)
    assert counter.launches == 2 * n == len(calls)
    assert [name for name, _ in calls] == [
        "pwg_stack_layer_gate", "pwg_stack_layer_out"] * n
    ins, xbs = [], []
    for i in range(n):
        (xb, c_ptr, wg_p, h, *ints, stream) = calls[2 * i][1]
        assert (c_ptr, wg_p, stream) == (c16.data_ptr(), wg[i].data_ptr(),
                                         1234)
        assert ints == [b, t, cr, ca, ca, kp, [1, 2][i % 2]]
        (h_in, x_in, x_f32, x_bf16, xb_out, wso_p, bso_p, skip_p,
         *ints, stream) = calls[2 * i + 1][1]
        assert h_in == h
        assert (wso_p, bso_p, skip_p) == (wso[i].data_ptr(),
                                          bso[i].data_ptr(), skip.data_ptr())
        last = i == n - 1
        if last:
            assert (x_f32, x_bf16) == ((out.data_ptr(), None) if save
                                       else (None, out.data_ptr()))
            assert xb_out is None
        elif save:
            assert xb_out == saved[i + 1].data_ptr()
        assert ints == [b, t, cr, int(i == 0), int((i + 1) % per == 0)]
        ins.append(x_in)
        xbs.append((xb, xb_out))
    assert len(set(ins)) == 2
    if save:
        assert xbs[0][0] == saved[0].data_ptr()
        assert torch.equal(saved[0], x16)
    else:
        assert xbs[0][0] == x16.data_ptr()
        assert len({xb for pair in xbs[1:] for xb in pair} - {None}) == 1
    assert all(xbs[i][1] == xbs[i + 1][0] for i in range(n - 1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mangled,name", [
    ("_ZN41_INTERNAL_0a1b2c3d_12_pwg_stack_cu_9f8e7d6c16pwg_layer_kernel"
     "ILi64ELb1EEEvPKfPfP13__nv_bfloat16", "pwg_layer_kernel<64, true>"),
    ("_ZN41_INTERNAL_0a1b2c3d_12_pwg_stack_cu_9f8e7d6216pwg_layer_kernel"
     "ILi32ELb0EEEvPKf", "pwg_layer_kernel<32, false>"),
    ("_ZN42_INTERNAL_0a1b2c3d_13_flash_attn_cu_9f8e7d6c15flash_dq_kernel"
     "IfLi96EEEvPKT_", "flash_dq_kernel<float, 96>"),
    ("_ZN42_INTERNAL_0a1b2c3d_13_flash_attn_cu_9f8e7d6c15flash_dq_kernel"
     "I13__nv_bfloat16Li128EEEvPKT_", "flash_dq_kernel<bf16, 128>"),
    ("_ZN46_INTERNAL_0a1b2c3d_16_pwg_stack_bwd_cu_9f8e7d6c13k2b_dw_kernel"
     "ILi64EEEvPK13__nv_bfloat16", "k2b_dw_kernel<64>"),
    ("_ZN3ptk46_INTERNAL_0a1b2c3d_16_pwg_stack_bwd_cu_9f8e7d6c22reduce_"
     "partials_kernelEPKfPfix", "reduce_partials_kernel"),
    # the residual width 128's instances (pwg_stack_cr128.cu,
    # pwg_stack_bwd_cr128.cu), as nvcc 12 names them
    ("_ZN55_GLOBAL__N__5b87a165_18_pwg_stack_cr128_cu_4b2ea08e15pwg_gate_"
     "kernelEPKfPK13__nv_bfloat16S4_PS2_iiiiii", "pwg_gate_kernel"),
    ("_ZN55_GLOBAL__N__5b87a165_18_pwg_stack_cr128_cu_4b2ea08e14pwg_out_"
     "kernelILb1EEEvPK13__nv_bfloat16PKfPfPS2_", "pwg_out_kernel<true>"),
    ("_ZN3ptk55_GLOBAL__N__5b87a165_22_pwg_stack_bwd_cr128_cu_4b2ea08e15k2b_"
     "gate_kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS4_S6_PS2_Pfiiiiiiix",
     "k2b_gate_kernel<128>"),
])
def test_chip_smoke_names_the_kernels(mangled, name):
    """The ptxas report names each instance with its template arguments,
    so that K1's and K2a's instances (SAVE false and true) are told
    apart."""
    smoke = _chip_smoke()
    assert smoke.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 168 registers, 380 bytes cmem[0]\n")
    assert smoke.ptxas_entries(log) == [(name, 168, 8, 12)]
