"""Flash attention (kernel K4) of the PyTorch port against the JAX package.

The plain versions of K4a/K4b/K4c, through the port's flash core, are held
against jax's Pallas flash kernel in interpret mode (as
tests/test_flash_attention.py runs it, with seq_block=128 so that T=200
crosses two blocks, and a padding mask), at JAX's own tolerances; then
the port's flash core against its dense MultiHeadAttention, the 'auto'
dispatch, the attention-dropout rules of MultiHeadAttention and the
dropout module.  Inputs are drawn with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.nn.flash import make_flash_attn_core as j_flash_core
from parakeet_tpu_torch.nn import flash as tflash
from parakeet_tpu_torch.nn import transformer as ttr
from parakeet_tpu_torch.nn.dropout import Dropout
from parakeet_tpu_torch.ops.kernels import flash_attn as k4

torch.set_num_threads(1)

# float32 sums in other orders: 1e-5 on outputs of order one
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None])[:, None, :]


@pytest.mark.parametrize("b,t,h,dk,lengths", [
    (2, 200, 2, 32, (200, 131)),
    # FastSpeech2's encoder self-attention at the head width the kernels
    # are tuned for (adim 384 over 4 heads), 64 text tokens
    (4, 64, 4, 96, (64, 48, 57, 50))])
def test_plain_k4_matches_pallas_flash_kernel(b, t, h, dk, lengths):
    """Forward and VJP of the port's flash core (the plain K4a/K4b/K4c on
    the CPU) against jax's Pallas TPU kernel in interpret mode, with
    ragged key lengths: B=2, T=200, H=2, dk=32, and the encoder's B=4,
    T=64, H=4, dk=96.  Tolerances are JAX's own
    (tests/test_flash_attention.py): output 1e-5 abs, gradients atol 2e-4
    / rtol 2e-3.  A key-padding mask makes every query row valid, so
    every row attends to the same keys on both sides (jax's kernel also
    sees the keys it pads T to a multiple of 128 with, masked), and all
    rows are held."""
    q, k, v, w = (_np(s, b, t, h, dk) for s in (0, 1, 2, 3))
    mask = _mask(list(lengths), t)
    j_core = j_flash_core(seq_block=128)

    def jloss(q, k, v):
        out = j_core(q, k, v, jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    launches = [f.launches for f in (k4.flash_attention_forward,
                                     k4.flash_attention_dkv,
                                     k4.flash_attention_dq)]
    got = tflash.make_flash_attn_core(seq_block=128)(
        tq, tk, tv, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    assert launches == [f.launches for f in (k4.flash_attention_forward,
                                             k4.flash_attention_dkv,
                                             k4.flash_attention_dq)]
    assert got.shape == (b, t, h, dk)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() < 1e-5
    for name, g, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_segment_rule_for_rows_that_may_attend_to_nothing():
    """With per-row validities on both sides (a mask that is False for
    whole query rows), a query row attends to the keys of its own
    validity, as jax's segment ids: a valid row to the valid keys, an
    invalid row to the invalid keys."""
    b, h, t, d = 1, 1, 10, 16
    q, k, v = (torch.from_numpy(_np(s, b, h, t, d)) for s in (20, 21, 22))
    valid = (torch.arange(t) < 6).to(torch.int32)[None]
    o, _ = k4.flash_attention_reference(q, k, v, valid, valid, sm_scale=0.5)
    for rows in (slice(0, 6), slice(6, t)):
        p = torch.softmax(0.5 * q[0, 0, rows] @ k[0, 0, rows].T, -1)
        torch.testing.assert_close(o[0, 0, rows], p @ v[0, 0, rows],
                                   **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k4_saves_the_logsumexp_and_rounds_p_to_v_dtype(dtype):
    """lse is log(sum(exp(s))) of the masked scores, and in bf16 the
    output is (T(p) . v) / l with p rounded to bf16, as jax's kernel."""
    b, h, t, d = 1, 2, 40, 16
    q, k, v = (torch.from_numpy(_np(s, b, h, t, d)).to(dtype)
               for s in (4, 5, 6))
    qv = torch.ones((b, t), dtype=torch.int32)
    kv = (torch.arange(t) < 29).to(torch.int32)[None]
    o, lse = k4.flash_attention_reference(q, k, v, qv, kv, sm_scale=0.25)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * 0.25
    s = s.masked_fill(kv[:, None, None, :] == 0, -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **F32_TOL)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.einsum("bhqk,bhkd->bhqd", p.to(dtype).float(), v.float())
            / p.sum(-1, keepdim=True)).to(dtype)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), want.float(), **F32_TOL)


# K4a against its plain version, relative to the output's range, as
# chip_smoke.py's K4_REL_TOL: float32 rounding (2^-14), or a flipped bf16
# rounding of p (2^-7, two bf16 ulps)
K4_REL_TOL = {torch.float32: 2 ** -14, torch.bfloat16: 2 ** -7}


def _k4_case(dtype, b=3, h=2, tq=150, tk=203, d=32):
    """(q, k, v, q_valid, kv_valid) from numpy: item 0 all valid, item 1
    with key padding, item 2 with its last query rows invalid against all
    valid keys (rows that may attend to nothing, which attend to every key
    alike)."""
    q, k, v = (torch.from_numpy(_np(40 + i, b, h, t, d)).to(dtype)
               for i, t in enumerate((tq, tk, tk)))
    kv_valid = torch.from_numpy(
        np.arange(tk)[None] < np.array([tk, 120, tk])[:, None]).int()
    q_valid = torch.from_numpy(
        np.arange(tq)[None] < np.array([tq, tq, 90])[:, None]).int()
    return q, k, v, q_valid, kv_valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k4a_unblocked_is_the_one_shot_softmax(dtype):
    """block_k=None is the softmax at the row's final max, bit for bit."""
    q, k, v, qv, kv = _k4_case(dtype)
    o, lse = k4.flash_attention_reference(q, k, v, qv, kv, sm_scale=0.3)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * 0.3
    s = s + torch.where(qv[:, None, :, None] == kv[:, None, None, :], 0.0,
                        k4.MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    want = torch.einsum("bhqk,bhkd->bhqd", p.to(dtype).float(), v.float())
    want = (want * torch.where(l == 0, 1.0, 1.0 / l)).to(dtype)
    assert torch.equal(o, want)
    assert torch.equal(lse, (m + torch.log(l))[..., 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k4a_blocked_matches_unblocked(dtype):
    """The kernel's statement, keys in tiles of K4A_BLOCK_K and of a width
    that leaves a ragged last tile (203 = 3 * 64 + 11), within K4_REL_TOL
    of the unblocked one on every row."""
    args = _k4_case(dtype)
    want_o, want_lse = k4.flash_attention_reference(*args, sm_scale=0.3)
    for block_k in (k4.K4A_BLOCK_K[dtype], 64 if dtype == torch.float32
                    else 48):
        o, lse = k4.flash_attention_reference(*args, sm_scale=0.3,
                                              block_k=block_k)
        assert o.dtype == dtype and lse.dtype == torch.float32
        for got, want in ((o, want_o), (lse, want_lse)):
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            assert err <= K4_REL_TOL[dtype] * want.abs().max().item(), (
                block_k, err)


def test_plain_k4a_blocked_matches_pallas_flash_kernel():
    """The blocked float32 statement at K4A_BLOCK_K against jax's Pallas
    kernel in interpret mode, as test_plain_k4_matches_pallas_flash_kernel
    runs it (T=200, seq_block=128, key lengths (200, 131)), at 1e-5."""
    b, t, h, dk = 2, 200, 2, 32
    q, k, v = (_np(s, b, t, h, dk) for s in (0, 1, 2))
    mask = _mask([200, 131], t)
    want = j_flash_core(seq_block=128)(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(mask))
    q_valid, kv_valid = tflash._validity(torch.from_numpy(mask), b, t, t)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got, _ = k4.flash_attention_reference(
        *heads, q_valid, kv_valid, sm_scale=dk ** -0.5,
        block_k=k4.K4A_BLOCK_K[torch.float32])
    assert np.abs(got.transpose(1, 2).numpy() - np.asarray(want)).max() < 1e-5


def test_auto_core_runs_dense_at_head_widths_k4_does_not_take(monkeypatch):
    """dk = 192 (adim 384, 2 heads, as every FastSpeech2 recipe YAML) at
    T = 1024: 'auto' runs the dense path, bit for bit, and never reaches
    K4; 'flash' raises there."""
    h, d, t = 2, 384, 1024
    core = tflash.make_auto_attn_core()
    dense, auto = _mha_pair(h, d, core, 15, rate=0.1)

    def no_k4(*args, **kwargs):
        raise AssertionError("K4 reached at dk = 192")

    monkeypatch.setattr(tflash, "flash_attention", no_k4)
    x = torch.from_numpy(_np(16, 1, t, d))
    heads = x.view(1, t, h, d // h)
    assert core(heads, heads, heads) is None
    torch.testing.assert_close(auto(x, x, x, deterministic=True),
                               dense(x, x, x, deterministic=True),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="K4"):
        tflash.make_flash_attn_core()(heads, heads, heads)


def _mha_pair(h, d, core, seed, rate=0.0):
    dense = ttr.MultiHeadAttention(h, d, rate)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dense.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / d ** 0.5)
    other = ttr.MultiHeadAttention(h, d, rate, attn_core=core)
    other.load_state_dict(dense.state_dict())
    return dense, other


def test_flash_core_matches_dense_attention():
    """The port's flash core inside MultiHeadAttention against the dense
    core under a key-padding mask, outputs of every row (padded query rows
    attend to the valid keys under both rules) and every gradient
    (float32, 1e-5)."""
    h, d, t = 2, 32, 70
    dense, flash = _mha_pair(h, d, tflash.make_flash_attn_core(), 7)
    x = _np(8, 2, t, d)
    mask = torch.from_numpy(_mask([70, 45], t))
    w = torch.from_numpy(_np(9, 2, t, d))
    outs, grads = [], []
    for mha in (dense, flash):
        tx = torch.tensor(x, requires_grad=True)
        out = mha(tx, tx, tx, mask)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append([tx.grad] + [p.grad for p in mha.parameters()])
    torch.testing.assert_close(outs[1], outs[0], **F32_TOL)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_auto_core_dispatch_on_both_sides_of_the_threshold():
    """Below the threshold the auto core returns None and the dense path
    runs (bit for bit); at it, flash attention runs."""
    h, d, thr = 2, 32, 48
    core = tflash.make_auto_attn_core(threshold=thr)
    assert core.dense_fallback is True
    dense, auto = _mha_pair(h, d, core, 10)
    for t in (thr - 1, thr):
        x = torch.from_numpy(_np(11 + t, 1, t, d))
        heads = x.view(1, t, h, d // h)
        used_flash = core(heads, heads, heads) is not None
        assert used_flash == (t >= thr)
        got, want = auto(x, x, x), dense(x, x, x)
        if used_flash:
            torch.testing.assert_close(got, want, **F32_TOL)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_attention_dropout_rules_of_custom_cores():
    """Training with attention dropout: a fixed core raises (it would
    silently drop the regularization); the auto core falls back to the
    dense path, whose masks come from the given generator."""
    h, d, t = 2, 32, 64
    x = torch.from_numpy(_np(12, 1, t, d))
    _, flash = _mha_pair(h, d, tflash.make_flash_attn_core(), 13, rate=0.1)
    with pytest.raises(ValueError, match="dropout"):
        flash(x, x, x, deterministic=False, rng=torch.Generator())
    # deterministic, or at rate 0, the fixed core runs
    flash(x, x, x, deterministic=True)
    dense, auto = _mha_pair(h, d, tflash.make_auto_attn_core(threshold=8),
                            14, rate=0.1)
    got = auto(x, x, x, deterministic=False,
               rng=torch.Generator().manual_seed(3))
    want = dense(x, x, x, deterministic=False,
                 rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, dense(x, x, x))     # dropout did act


def test_dropout_keeps_scales_and_draws_from_its_generator():
    x = torch.ones(200_000)
    drop = Dropout(0.3)
    out = drop(x, deterministic=False, rng=torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.7),
                               rtol=0, atol=0)
    again = drop(x, deterministic=False,
                 rng=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    other = drop(x, deterministic=False,
                 rng=torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    # deterministic, or at rate 0: the identity, and nothing is drawn
    for module, det in ((drop, True), (Dropout(0.0), False)):
        gen = torch.Generator().manual_seed(5)
        state = gen.get_state()
        assert module(x, deterministic=det, rng=gen) is x
        assert torch.equal(gen.get_state(), state)
    assert torch.equal(Dropout(1.0)(x, deterministic=False),
                       torch.zeros_like(x))
    with pytest.raises(ValueError, match="torch.Generator"):
        drop(x, deterministic=False)
