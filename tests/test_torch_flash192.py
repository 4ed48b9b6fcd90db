"""Flash attention (kernel K4) of the PyTorch port at head width 192, the
FastSpeech2 recipes' adim 384 over 2 heads, against the JAX package.

jax's Pallas flash kernel takes dk 192 only where the padded length is
one block (its multi-step kernel raises unless head_dim is a multiple of
128 above 128), so it is held at T=200 (padded to one block of 256) in
interpret mode, as tests/test_flash_attention.py runs it.  Past one block
the JAX core raises; the port's plain flash path is held there against a
float64 softmax instead.  Inputs are drawn with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.nn.flash import make_flash_attn_core as j_flash_core
from parakeet_tpu_torch.nn import flash as tflash
from parakeet_tpu_torch.nn import transformer as ttr
from parakeet_tpu_torch.ops.kernels import flash_attn as k4

torch.set_num_threads(1)

DK = 192


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _row_mask(lengths, t):
    """(B, 1, T, T) self-attention mask of valid rows and keys: the rows
    past an item's length may attend to nothing."""
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return (valid[:, :, None] & valid[:, None, :])[:, None]


def test_k4_takes_head_width_192():
    """Every multiple of 16 in [16, 1024] is taken (widths between two
    instances run at the wider one: 144-192 at 192, 208-256 at 256, and
    above 256 at the next multiple of 128); past 1024 (jax's kernel also
    takes 1152) and off the multiples of 16 K4 refuses."""
    assert k4.flash_head_dim_supported(DK)
    assert all(k4.flash_head_dim_supported(d) for d in range(16, 1025, 16))
    assert not any(k4.flash_head_dim_supported(d)
                   for d in (0, 8, 24, 200, 250, 392, 1040, 1152))
    assert [k4.k4_padded_dim(d) for d in (16, 48, 128, 144, 192, 208, 256)
            ] == [32, 64, 128, 192, 192, 256, 256]
    assert [k4.k4_padded_dim(d) for d in (272, 384, 400, 512, 528, 640,
                                          768, 1024)
            ] == [384, 384, 512, 512, 640, 640, 768, 1024]


def test_plain_k4_matches_pallas_flash_kernel_at_dk_192():
    """Forward and VJP of the port's flash core (the plain K4a/K4b/K4c on
    the CPU) against jax's Pallas kernel in interpret mode at B=2, T=200
    (one block of 256 after jax's padding), H=2, dk=192, lengths 200 and
    131 with the rows past each length masked too.  A masked row attends
    to the invalid keys under both segment rules, but jax's include the
    zero keys it pads T with, so outputs are held on the valid rows and
    the loss weighs those rows only; every gradient is held.  Tolerances
    are JAX's own: output 1e-5 abs, gradients atol 2e-4 / rtol 2e-3."""
    b, t, h = 2, 200, 2
    lengths = (200, 131)
    q, k, v, w = (_np(s, b, t, h, DK) for s in (0, 1, 2, 3))
    mask = _row_mask(lengths, t)
    rows = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
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


def test_jax_core_raises_past_one_block_where_the_port_runs():
    """A reference fault the port does not inherit: at dk 192 and T=640
    (padded to 640, blocks of 128) jax's multi-step kernel raises.  The
    port's flash core runs there, and its output and gradients match a
    float64 softmax of the same inputs (key lengths 640 and 517)."""
    b, t, h = 2, 640, 2
    lengths = (640, 517)
    q, k, v, w = (_np(s, b, t, h, DK) for s in (4, 5, 6, 7))
    key_mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    mask = key_mask[:, None, :]
    with pytest.raises(NotImplementedError, match="head_dim"):
        j_flash_core()(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask))

    def attend(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / DK ** 0.5
        s = s.masked_fill(~torch.from_numpy(key_mask)[:, None, None, :],
                          -float("inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    outs, grads = [], []
    for core, dtype in ((tflash.make_flash_attn_core(), torch.float32),
                        (attend, torch.float64)):
        x = [torch.tensor(a, dtype=dtype, requires_grad=True)
             for a in (q, k, v)]
        out = (core(*x, torch.from_numpy(mask)) if dtype == torch.float32
               else core(*x))
        (out * torch.from_numpy(w).to(dtype)).sum().backward()
        outs.append(out.detach().double())
        grads.append([a.grad.double() for a in x])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_flash_core_matches_dense_attention_at_dk_192():
    """The port's 'flash' core inside MultiHeadAttention (adim 384, 2
    heads) against the dense core under a key-padding mask: outputs of
    every row and every gradient (float32, 1e-5)."""
    h, d, t = 2, 2 * DK, 70
    dense = ttr.MultiHeadAttention(h, d)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in dense.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / d ** 0.5)
    flash = ttr.MultiHeadAttention(h, d,
                                   attn_core=tflash.make_flash_attn_core())
    flash.load_state_dict(dense.state_dict())
    x = _np(18, 2, t, d)
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.array([70, 45])[:, None])[:, None, :])
    w = torch.from_numpy(_np(19, 2, t, d))
    outs, grads = [], []
    for mha in (dense, flash):
        tx = torch.tensor(x, requires_grad=True)
        out = mha(tx, tx, tx, mask)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append([tx.grad] + [p.grad for p in mha.parameters()])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_auto_core_runs_dense_at_dk_192(monkeypatch):
    """'auto' at dk 192 stays dense (flash wins no train step there on
    the H100: nn/flash.py's auto_flash_head_dim), bit for bit, at T = 1024
    past its threshold, while 'flash' runs K4 at that width."""
    h, d, t = 2, 2 * DK, 1024
    assert not tflash.auto_flash_head_dim(DK)
    assert tflash.auto_flash_head_dim(96) and tflash.auto_flash_head_dim(128)
    core = tflash.make_auto_attn_core()
    dense = ttr.MultiHeadAttention(h, d)
    auto = ttr.MultiHeadAttention(h, d, attn_core=core)
    auto.load_state_dict(dense.state_dict())
    x = torch.from_numpy(_np(20, 1, t, d))
    heads = x.view(1, t, h, DK)
    calls = []
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or a[0])
    assert core(heads, heads, heads) is None and not calls
    torch.testing.assert_close(auto(x, x, x), dense(x, x, x), rtol=0,
                               atol=0)
    tflash.make_flash_attn_core()(heads, heads, heads)
    assert calls == [(1, h, t, DK)]
