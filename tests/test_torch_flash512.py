"""Flash attention (kernel K4) of the PyTorch port at head widths 384 and
512 (adim 384 and 512 over one head) against the JAX package.

jax's Pallas flash kernel takes every multiple of 128 in one block and
across several, so the port's plain K4a/K4b/K4c, through its flash core,
are held against it in interpret mode, as tests/test_flash_attention.py
runs it: o, lse (jax's saved m + log l) and every gradient, at dk 384 over
T=200 (one block after jax's padding) and T=640 (five blocks of 128), at
dk 512 over T=200, at dk 384 with Tq != Tk, and at dk 640, 768 and 1024
(the widest K4 takes) over T=128.  The widths padded to the DP = 384 and 512 instances
(320, 448) are held against a float64 softmax, and a FastSpeech2 at adim
384 over one head with 'flash' against the JAX model with the same
weights.  Inputs are drawn with numpy from a seed.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.models.fastspeech2 import fastspeech2_loss as j_loss
from parakeet_tpu.nn import flash as jflash
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import FastSpeech2, fastspeech2_loss
from parakeet_tpu_torch.nn import flash as tflash
from parakeet_tpu_torch.nn import transformer as ttr
from parakeet_tpu_torch.ops.kernels import flash_attn as k4
from test_torch_fs2_train import (BATCH_KEYS, NO_DROPOUT, _assert_stats_match,
                                  _batch, _jax_apply, _randomize,
                                  _torch_batch)

torch.set_num_threads(1)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rows(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _jax_lse(q, k, v, mask):
    """jax's kernel's saved statistics as lse = m + log l, (B, H, Tq), with
    the padding and blocks of parakeet_tpu/nn/flash.py's core (which runs
    first in each test, so the interpreter is on)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa
    b, tq, h, dk = q.shape
    tk = k.shape[1]
    tq_p, tk_p = -(-tq // 128) * 128, -(-tk // 128) * 128
    bq, bk = jflash._seq_block(tq_p, 512), jflash._seq_block(tk_p, 512)
    blocks = fa.BlockSizes(
        block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
        block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk,
        block_q_dkv=bq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)
    q_valid, kv_valid = jflash._validity(jnp.asarray(mask), b, tq, tk)
    seg = fa.SegmentIds(q=jnp.pad(q_valid, ((0, 0), (0, tq_p - tq))),
                        kv=jnp.pad(kv_valid, ((0, 0), (0, tk_p - tk))))

    def heads(x, t_p):
        x = jnp.pad(jnp.asarray(x), ((0, 0), (0, t_p - x.shape[1]), (0, 0),
                                     (0, 0)))
        return jnp.swapaxes(x, 1, 2)
    _, l, m = fa._flash_attention(
        heads(q, tq_p), heads(k, tk_p), heads(v, tk_p), None, seg, True,
        False, dk ** -0.5, blocks, False)
    return np.asarray(m + jnp.log(l))[:, :, :tq]


@pytest.mark.parametrize("dk,tq,tk,q_lengths,k_lengths", [
    (384, 200, 200, (200, 131), (200, 131)),
    (384, 640, 640, (640, 411), (640, 411)),
    (512, 200, 200, (200, 131), (200, 131)),
    (384, 130, 256, (130, 70), (256, 190)),
    (640, 128, 128, (128, 77), (128, 77)),
    (768, 128, 128, (128, 77), (128, 77)),
    (1024, 128, 128, (128, 77), (128, 77))])
def test_plain_k4_matches_pallas_flash_kernel_at_wide_dk(dk, tq, tk,
                                                         q_lengths,
                                                         k_lengths):
    """Forward and VJP of the port's flash core (the plain K4a/K4b/K4c on
    the CPU) against jax's Pallas kernel in interpret mode at B=2, H=1:
    dk 384 over T=200 (one block of 256 after jax's padding) and T=640
    (five blocks of 128), dk 512 over T=200, dk 384 with 130 queries over
    256 keys, and dk 640, 768 and 1024 (K4's widest) over T=128; the
    second item
    ragged, with the rows past its length masked too.  A masked row
    attends to the invalid keys under both segment rules, and jax's
    include any zero keys it pads T with, so o and lse are held on the
    valid rows and the loss weighs those rows only; every gradient is
    held.  Tolerances are JAX's own: output 1e-5
    abs, gradients atol 2e-4 / rtol 2e-3; lse (about log T) 2e-5 abs."""
    b, h = 2, 1
    q = _np(dk + tq, b, tq, h, dk)
    k, v = (_np(dk + tk + s, b, tk, h, dk) for s in (1, 2))
    w = _np(dk + 3, b, tq, h, dk)
    q_rows, k_rows = _rows(q_lengths, tq), _rows(k_lengths, tk)
    mask = (q_rows[:, :, None] & k_rows[:, None, :])[:, None]
    w = w * q_rows[:, :, None, None]
    j_core = jflash.make_flash_attn_core()

    def jloss(q, k, v):
        out = j_core(q, k, v, jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_lse = _jax_lse(q, k, v, mask)
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tflash.make_flash_attn_core()(tq_, tk_, tv_, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (b, tq, h, dk)
    err = np.abs(got.detach().numpy() - np.asarray(want))[q_rows]
    assert err.max() < 1e-5
    q_valid, kv_valid = tflash._validity(torch.from_numpy(mask), b, tq, tk)
    _, lse = k4.flash_attention_reference(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)), q_valid,
        kv_valid, sm_scale=dk ** -0.5)
    lse_err = np.abs(lse.numpy() - want_lse).transpose(0, 2, 1)[q_rows]
    assert lse_err.max() < 2e-5
    for name, g, jg in zip("qkv", (tq_.grad, tk_.grad, tv_.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_plain_k4a_blocked_at_the_wide_tile():
    """K4a's statement at the wide instances' key tile (``k4a_block_k``:
    32 keys in float32 and in bf16, as at DP = 256): float32 at dk 384
    against jax's Pallas kernel in interpret mode at T=256 (two of its
    blocks, a ragged key length, every query row valid) at 1e-5; bf16
    against the unblocked statement within two bf16 ulps of the output's
    range (2^-7), as test_torch_flash256.py holds DP = 256."""
    assert [k4.k4a_block_k(dt, d) for dt in (torch.float32, torch.bfloat16)
            for d in (272, 384, 512, 640)] == [32] * 8
    dk, b, t, h = 384, 2, 256, 1
    q, k, v = (_np(s, b, t, h, dk) for s in (8, 9, 10))
    key_mask = _rows((256, 203), t)[:, None, :]
    want = jflash.make_flash_attn_core()(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask))
    q_valid, kv_valid = tflash._validity(torch.from_numpy(key_mask), b, t, t)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got, _ = k4.flash_attention_reference(
        *heads, q_valid, kv_valid, sm_scale=dk ** -0.5,
        block_k=k4.k4a_block_k(torch.float32, dk))
    assert np.abs(got.transpose(1, 2).numpy() - np.asarray(want)).max() < 1e-5
    bf = [x.to(torch.bfloat16) for x in heads]
    one, lse1 = k4.flash_attention_reference(*bf, q_valid, kv_valid,
                                             sm_scale=dk ** -0.5)
    blk, lse2 = k4.flash_attention_reference(
        *bf, q_valid, kv_valid, sm_scale=dk ** -0.5,
        block_k=k4.k4a_block_k(torch.bfloat16, dk))
    assert blk.dtype == torch.bfloat16
    for got, ref in ((blk, one), (lse2, lse1)):
        got, ref = got.float(), ref.float()
        assert (got - ref).abs().max() <= 2 ** -7 * ref.abs().max()


@pytest.mark.parametrize("dk,padded", [(320, 384), (448, 512)])
def test_padded_widths_match_a_float64_softmax(dk, padded):
    """Head widths between two multiples of 128 run at the wider padding
    with zero columns (320 at DP = 384, 448 at 512; jax's kernel takes
    neither past one block).  The port's flash core at T=300 against a
    float64 softmax of the same inputs, key lengths 300 and 187: output
    1e-5 abs, gradients rtol 1e-4 / atol 1e-5, as test_torch_flash192.py
    holds dk 192."""
    assert k4.k4_padded_dim(dk) == padded
    b, t, h = 2, 300, 1
    q, k, v, w = (_np(s + dk, b, t, h, dk) for s in (0, 1, 2, 3))
    key_mask = _rows((300, 187), t)

    def attend(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / dk ** 0.5
        s = s.masked_fill(~torch.from_numpy(key_mask)[:, None, None, :],
                          -float("inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    outs, grads = [], []
    for core, dtype in ((tflash.make_flash_attn_core(), torch.float32),
                        (attend, torch.float64)):
        x = [torch.tensor(a, dtype=dtype, requires_grad=True)
             for a in (q, k, v)]
        out = (core(*x, torch.from_numpy(key_mask[:, None, :]))
               if dtype == torch.float32 else core(*x))
        (out * torch.from_numpy(w).to(dtype)).sum().backward()
        outs.append(out.detach().double())
        grads.append([a.grad.double() for a in x])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_shared_memory_of_the_wide_instances():
    """``k4_smem_bytes`` (the kernels' geometry; the card test holds it
    against ``flash_attn_smem``) above DP = 256 by hand, the same at every
    wide width.  K4a: two stages, each the larger of a chunk step (64 rows
    of Q and 32 of K, 272 bytes a row: 64 float32 or 128 bf16 columns and
    16 bytes of pitch) and an out step (32 rows of V over 256 columns and
    16 bytes), then kv_valid.  K4b and K4c, a block of a cluster, rows of
    up to 256 columns at a pitch of 256 values and 16 bytes (1,040 bytes
    float32, 528 bf16): two resident strips of 64 rows (K4b K and V, K4c
    Q and dO), two stages of two tiles of 16 rows (float32) or 32 (bf16)
    and 3 (K4b: q_valid, lse, di) or 1 (K4c: kv_valid) vectors of a value
    a tile row, and two slots of the S and dP partials, 64 by 16 or 32
    float32 each.  One block (of 8 warps) an SM."""
    chunk = 272
    out = {torch.float32: 32 * 4 * 260, torch.bfloat16: 32 * 2 * 264}
    pitch = {torch.float32: 1040, torch.bfloat16: 528}
    bn = {torch.float32: 16, torch.bfloat16: 32}
    for dt in (torch.float32, torch.bfloat16):
        rows, tile, n = 64 * pitch[dt], bn[dt] * pitch[dt], bn[dt]
        slots = 2 * 2 * 64 * n * 4
        want = {"K4a": 2 * (max(96 * chunk, out[dt]) + 128),
                "K4b": 2 * rows + 2 * (2 * tile + 3 * 4 * n) + slots,
                "K4c": 2 * rows + 2 * (2 * tile + 4 * n) + slots}
        for d in (272, 384, 448, 512, 640, 768, 896, 1024):
            assert {n: k4.k4_smem_bytes(n, dt, d) for n in want} == want
    assert [k4.k4_smem_bytes(n, dt, 384) for dt in (torch.float32,
                                                     torch.bfloat16)
            for n in ("K4a", "K4b", "K4c")] == [66816, 216448, 216192,
                                                 52480, 168704, 168192]
    sm = 233472                                  # an SM's 228 KB
    assert 216448 <= k4.SMEM_LIMIT and 168192 + 1024 > sm // 2


@pytest.mark.parametrize("dk", range(272, 1025, 16))
def test_wide_split_covers_the_padded_width(dk):
    """``k4_wide_split``: the wide K4b's and K4c's cluster covers [0,
    ``k4_padded_dim(dk)``) with its blocks' column chunks once, in order,
    each a multiple of 16 and at most 256 columns, in at most 8 blocks
    (the portable cluster size): ceil(DP / 256) blocks, DP / C columns
    rounded up to 32 each, the last the rest (at least 16 of them real
    columns, below dk)."""
    chunks = k4.k4_wide_split(dk)
    dp = k4.k4_padded_dim(dk)
    covered = [c for c0, w in chunks for c in range(c0, c0 + w)]
    assert covered == list(range(dp))
    assert all(w % 16 == 0 and 0 < w <= 256 for _, w in chunks)
    assert len(chunks) <= k4.MAX_CLUSTER == 8
    assert len(chunks) == -(-dp // 256) and chunks[-1][0] + 16 <= dk
    assert [len(k4.k4_wide_split(d)) for d in (384, 512, 640, 1024)] == [
        2, 2, 3, 4]


@pytest.mark.parametrize("dk", [384, 512])
def test_auto_core_runs_dense_at_wide_dk(monkeypatch, dk):
    """'auto' at dk 384 and 512 stays dense (flash wins no float32 train
    step there on the H100: nn/flash.py's auto_flash_head_dim), bit for
    bit, at T = 1024 past its threshold, while 'flash' runs K4 at those
    widths."""
    h, t = 1, 1024
    assert not tflash.auto_flash_head_dim(dk)
    core = tflash.make_auto_attn_core()
    dense = ttr.MultiHeadAttention(h, dk)
    auto = ttr.MultiHeadAttention(h, dk, attn_core=core)
    auto.load_state_dict(dense.state_dict())
    x = torch.from_numpy(_np(21, 1, t, dk))
    heads = x.view(1, t, h, dk)
    calls = []
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or a[0])
    assert core(heads, heads, heads) is None and not calls
    torch.testing.assert_close(auto(x, x, x), dense(x, x, x), rtol=0,
                               atol=0)
    tflash.make_flash_attn_core()(heads, heads, heads)
    assert calls == [(1, h, t, dk)]


# FastSpeech2 at adim 384 over one head (every recipe YAML's widths with
# --opts model.aheads 1), one encoder and one decoder layer, narrow units,
# predictors and Postnet (test_torch_fs2_train.py's batch: 12 tokens, 128
# frames)
CFG_384 = dict(idim=20, odim=8, adim=384, aheads=1, elayers=1, eunits=64,
               dlayers=1, dunits=64, postnet_layers=2, postnet_chans=8,
               postnet_filts=5, duration_predictor_chans=16,
               pitch_predictor_chans=16, energy_predictor_chans=16,
               positionwise_layer_type="conv1d",
               positionwise_conv_kernel_size=3)


def test_fastspeech2_at_adim_384_over_one_head_matches_jax():
    """FastSpeech2 with attn_impl 'flash' at adim 384 over one head (dk
    384): JAX's weights (drawn with numpy) carried across by the bridge,
    the masked loss against JAX's (jax's Pallas kernel in interpret mode)
    at rtol 1e-5, every parameter's gradient leaf by leaf within 1e-3 of
    its range (+1e-6), and the Postnet's BatchNorm statistics, as
    test_torch_flash256.py holds adim 512 over 2 heads."""
    batch = _batch((12, 9), (128, 101), 37)
    jdense = JFS2(attn_impl="dense", **CFG_384, **NO_DROPOUT)
    v = jax.jit(lambda key: jdense.init(
        {"params": key}, *[jnp.asarray(batch[n]) for n in BATCH_KEYS],
        deterministic=False))(jax.random.PRNGKey(4))
    flat = _randomize(flatten_tree(v), 4)
    tm = FastSpeech2(attn_impl="flash", **CFG_384, **NO_DROPOUT)
    load_flax_params(tm, flat)
    assert tm.encoder.layer_0.self_attn.n_heads == 1
    assert tm.encoder.layer_0.self_attn.q.weight.shape == (384, 384)
    jm = JFS2(attn_impl="flash", **CFG_384, **NO_DROPOUT)
    variables = nest_flat(flat)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_fn(params):
        outputs, mutated = _jax_apply(jm, variables, batch, params)
        return j_loss(outputs, jbatch)["loss"], mutated["batch_stats"]

    (want_loss, stats), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tb = _torch_batch(batch)
    out = tm(*[tb[k] for k in BATCH_KEYS], deterministic=False)
    loss = fastspeech2_loss(out, tb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = copy.deepcopy(tm)
    load_flax_params(want, flatten_tree({"params": want_g,
                                         "batch_stats": stats}))
    wanted = dict(want.named_parameters())
    for name, p in tm.named_parameters():
        w = wanted[name].detach()
        assert p.grad is not None, name
        err = (p.grad - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-6, (name, err)
    _assert_stats_match(tm, stats)
