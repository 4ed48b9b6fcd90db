"""Flash attention (kernel K4) of the PyTorch port at head width 256
(adim 512 over 2 heads) against the JAX package.

jax's Pallas flash kernel takes dk 256 (a multiple of 128) in one block
and across several, so the port's plain K4a/K4b/K4c, through its flash
core, are held against it in interpret mode, as
tests/test_flash_attention.py runs it, at T=200 (one block after jax's
padding) and T=384 (three blocks of 128).  The widths padded to the
DP = 192 and 256 instances (176, 240) are held against a float64 softmax
past one block, and a FastSpeech2 at adim 512 over 2 heads with
'flash' against the JAX model with the same weights.  Inputs are drawn
with numpy from a seed.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.models.fastspeech2 import fastspeech2_loss as j_loss
from parakeet_tpu.nn.flash import make_flash_attn_core as j_flash_core
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

DK = 256


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rows(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("t,lengths", [(200, (200, 131)),
                                       (384, (384, 250))])
def test_plain_k4_matches_pallas_flash_kernel_at_dk_256(t, lengths):
    """Forward and VJP of the port's flash core (the plain K4a/K4b/K4c on
    the CPU) against jax's Pallas kernel in interpret mode at B=2, H=2,
    dk=256: T=200 (one block of 256 after jax's padding) and T=384 (three
    blocks of 128), the second item ragged with the rows past its length
    masked too.  A masked row attends to the invalid keys under both
    segment rules, and jax's include any zero keys it pads T with, so
    outputs are held on the valid rows and the loss weighs those rows
    only; every gradient is held.  Tolerances are JAX's own: output 1e-5
    abs, gradients atol 2e-4 / rtol 2e-3."""
    b, h = 2, 2
    q, k, v, w = (_np(s + t, b, t, h, DK) for s in (0, 1, 2, 3))
    rows = _rows(lengths, t)
    mask = (rows[:, :, None] & rows[:, None, :])[:, None]
    w = w * rows[:, :, None, None]
    j_core = j_flash_core()

    def jloss(q, k, v):
        out = j_core(q, k, v, jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tflash.make_flash_attn_core()(tq, tk, tv, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (b, t, h, DK)
    err = np.abs(got.detach().numpy() - np.asarray(want))[rows]
    assert err.max() < 1e-5
    for name, g, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_plain_k4a_blocked_at_the_dp_256_tile():
    """K4a's statement at the DP = 256 instances' key tile
    (``k4a_block_k``: 32 keys in float32 and in bf16, where the narrower
    instances take 64 in bf16): float32 against jax's Pallas kernel in
    interpret mode at T=384 (three of its blocks, a ragged key length,
    every query row valid) at 1e-5; bf16 against the unblocked statement
    within two bf16 ulps of the output's range (2^-7), as
    test_plain_k4a_blocked_matches_unblocked holds the narrower widths."""
    assert [k4.k4a_block_k(d, DK) for d in (torch.float32, torch.bfloat16)
            ] == [32, 32]
    assert [k4.k4a_block_k(torch.bfloat16, d) for d in (96, 192, 208)
            ] == [64, 64, 32]
    b, t, h = 2, 384, 2
    q, k, v = (_np(s, b, t, h, DK) for s in (8, 9, 10))
    key_mask = _rows((384, 203), t)[:, None, :]
    want = j_flash_core()(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(key_mask))
    q_valid, kv_valid = tflash._validity(torch.from_numpy(key_mask), b, t, t)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got, _ = k4.flash_attention_reference(
        *heads, q_valid, kv_valid, sm_scale=DK ** -0.5,
        block_k=k4.k4a_block_k(torch.float32, DK))
    assert np.abs(got.transpose(1, 2).numpy() - np.asarray(want)).max() < 1e-5
    bf = [x.to(torch.bfloat16) for x in heads]
    one, lse1 = k4.flash_attention_reference(*bf, q_valid, kv_valid,
                                             sm_scale=DK ** -0.5)
    blk, lse2 = k4.flash_attention_reference(
        *bf, q_valid, kv_valid, sm_scale=DK ** -0.5,
        block_k=k4.k4a_block_k(torch.bfloat16, DK))
    assert blk.dtype == torch.bfloat16
    for got, ref in ((blk, one), (lse2, lse1)):
        got, ref = got.float(), ref.float()
        assert (got - ref).abs().max() <= 2 ** -7 * ref.abs().max()


@pytest.mark.parametrize("dk,padded", [(176, 192), (240, 256)])
def test_padded_widths_match_a_float64_softmax(dk, padded):
    """Head widths between two instances run at the wider one with zero
    columns (176 at DP = 192, 240 at DP = 256).  The port's flash core at
    T=300 (past one key tile and one of jax's blocks; jax's kernel takes
    neither width past one block) against a float64 softmax of the same
    inputs, key lengths 300 and 187: output 1e-5 abs, gradients rtol 1e-4
    / atol 1e-5, as test_torch_flash192.py holds dk 192."""
    assert k4.k4_padded_dim(dk) == padded
    b, t, h = 2, 300, 2
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


def test_shared_memory_of_the_dp_256_instances():
    """``k4_smem_bytes`` (the kernels' geometry; the card test holds it
    against ``flash_attn_smem``) at DP = 256 by hand: K4a Q resident (64
    rows of 256 + 16 bytes' pitch) and two stages of a K and a V tile of
    32 keys and their validities; K4b and K4c two resident strips and two
    stages of two tiles (16 rows in float32, 32 in bf16) and 3 or 1
    vectors.  Every width K4 takes fits in the 227 KB a block may have."""
    f32, b16 = 4 * 260, 2 * 264          # bytes a row
    want = {("K4a", torch.float32): 64 * f32 + 2 * (2 * 32 * f32 + 128),
            ("K4a", torch.bfloat16): 64 * b16 + 2 * (2 * 32 * b16 + 128),
            ("K4b", torch.float32): 128 * f32 + 2 * (2 * 16 * f32 + 192),
            ("K4b", torch.bfloat16): 128 * b16 + 2 * (2 * 32 * b16 + 384),
            ("K4c", torch.float32): 128 * f32 + 2 * (2 * 16 * f32 + 64),
            ("K4c", torch.bfloat16): 128 * b16 + 2 * (2 * 32 * b16 + 128)}
    assert {key: k4.k4_smem_bytes(*key, DK) for key in want} == want
    assert want[("K4a", torch.float32)] == 199936
    assert want[("K4b", torch.float32)] == 200064
    assert want[("K4c", torch.float32)] == 199808
    assert all(k4.k4_smem_bytes(n, dt, d) <= k4.SMEM_LIMIT
               for n in ("K4a", "K4b", "K4c")
               for dt in (torch.float32, torch.bfloat16)
               for d in range(16, 257, 16))


def test_auto_core_runs_dense_at_dk_256(monkeypatch):
    """'auto' at dk 256 stays dense (flash wins no float32 train step
    there on the H100: nn/flash.py's auto_flash_head_dim), bit for bit,
    at T = 1024 past its threshold, while 'flash' runs K4 at that
    width."""
    h, d, t = 2, 2 * DK, 1024
    assert not tflash.auto_flash_head_dim(DK)
    core = tflash.make_auto_attn_core()
    dense = ttr.MultiHeadAttention(h, d)
    auto = ttr.MultiHeadAttention(h, d, attn_core=core)
    auto.load_state_dict(dense.state_dict())
    x = torch.from_numpy(_np(21, 1, t, d))
    heads = x.view(1, t, h, DK)
    calls = []
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or a[0])
    assert core(heads, heads, heads) is None and not calls
    torch.testing.assert_close(auto(x, x, x), dense(x, x, x), rtol=0,
                               atol=0)
    tflash.make_flash_attn_core()(heads, heads, heads)
    assert calls == [(1, h, t, DK)]


# FastSpeech2 at adim 512 over 2 heads, one encoder and one decoder layer,
# narrow units, predictors and Postnet (test_torch_fs2_train.py's batch:
# 12 tokens, 128 frames)
CFG_512 = dict(idim=20, odim=8, adim=512, aheads=2, elayers=1, eunits=64,
               dlayers=1, dunits=64, postnet_layers=2, postnet_chans=8,
               postnet_filts=5, duration_predictor_chans=16,
               pitch_predictor_chans=16, energy_predictor_chans=16,
               positionwise_layer_type="conv1d",
               positionwise_conv_kernel_size=3)


def test_fastspeech2_at_adim_512_matches_jax():
    """FastSpeech2 with attn_impl 'flash' at adim 512 over 2 heads (dk
    256): JAX's weights (drawn with numpy) carried across by the bridge,
    the masked loss against JAX's (jax's Pallas kernel in interpret mode)
    at rtol 1e-5, every parameter's gradient leaf by leaf within 1e-3 of
    its range (+1e-6), and the Postnet's BatchNorm statistics, as
    test_torch_fs2_train.py holds the narrow model."""
    batch = _batch((12, 9), (128, 101), 31)
    jdense = JFS2(attn_impl="dense", **CFG_512, **NO_DROPOUT)
    v = jax.jit(lambda key: jdense.init(
        {"params": key}, *[jnp.asarray(batch[n]) for n in BATCH_KEYS],
        deterministic=False))(jax.random.PRNGKey(3))
    flat = _randomize(flatten_tree(v), 3)
    tm = FastSpeech2(attn_impl="flash", **CFG_512, **NO_DROPOUT)
    load_flax_params(tm, flat)
    assert tm.encoder.layer_0.self_attn.q.weight.shape == (512, 512)
    jm = JFS2(attn_impl="flash", **CFG_512, **NO_DROPOUT)
    variables = nest_flat(flat)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_fn(params):
        outputs, mutated = _jax_apply(jm, variables, batch, params)
        return j_loss(outputs, jbatch)["loss"], mutated["batch_stats"]

    (want_loss, stats), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tb = _torch_batch(batch)
    launches = [f.launches for f in (k4.flash_attention_forward,
                                     k4.flash_attention_dkv,
                                     k4.flash_attention_dq)]
    out = tm(*[tb[k] for k in BATCH_KEYS], deterministic=False)
    loss = fastspeech2_loss(out, tb)["loss"]
    loss.backward()
    # the CPU runs the plain versions: no kernel counts a launch
    assert launches == [f.launches for f in (k4.flash_attention_forward,
                                             k4.flash_attention_dkv,
                                             k4.flash_attention_dq)]
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
