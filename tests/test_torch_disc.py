"""Parallel WaveGAN discriminator of the PyTorch port against the JAX
package: the plain versions of kernels K3a/K3b against the Pallas kernels
(interpret mode, as tests/test_pwg_disc_pallas.py runs them, with a small
block so that T spans several), and ``PWGDiscriminator`` through the
weight bridge.  Inputs and weights are drawn with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.ops.pallas import pwg_disc as jdisc
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu_torch.bridge import load_flax_params
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.ops.kernels import pwg_disc as tdisc

torch.set_num_threads(1)

SLOPE = 0.2
T, B = 600, 2
# the plain versions round where the kernels do (bf16 operands, float32
# sums, bf16 layer inputs, bf16 dpre as the backward's operand); they
# differ from the Pallas kernels only in the order of float32 sums, which
# now and then flips a bf16 rounding of a layer input by one ulp (2^-8
# relative), and nine layers carry such flips on.  Held, as a share of
# each output's range, to 2^-6 forward and 2^-5 for gradients, which
# also meet the autograd reference's other rounding points.  Measured:
# logits 0.0045 (K3a) and 0.0059 (the module) against Pallas; gradients
# <= 0.0022 against the Pallas backward and <= 0.011 against autograd.
FWD_TOL = 2 ** -6
BWD_TOL = 2 ** -5
# the module's gradients against the JAX module's, in relative L2 (see
# test_discriminator_fused_matches_jax_pallas)
MODULE_GRAD_REL_L2 = 2 ** -3


def _weights(seed):
    """Unit-gain layers, as tests/test_pwg_disc_pallas.py draws them."""
    rng = np.random.default_rng(seed)
    ks, bs = [], []
    for j in range(len(tdisc.DISC_TAIL_DILS)):
        cout = 1 if j == len(tdisc.DISC_TAIL_DILS) - 1 else 64
        ks.append((rng.normal(size=(3, 64, cout)) / np.sqrt(192)).astype(
            np.float32))
        bs.append((rng.normal(size=(cout,)) * 0.05).astype(np.float32))
    return ks, bs


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: max abs err {err}"


@pytest.fixture
def small_block(monkeypatch):
    monkeypatch.setattr(jdisc, "_BLOCK", 256)


def test_k3a_reference_matches_pallas_forward(small_block):
    ks, bs = _weights(0)
    h = np.random.default_rng(1).normal(size=(B, T, 64)).astype(np.float32)
    wk, _, bk = jdisc._pack_weights([jnp.asarray(k) for k in ks],
                                    [jnp.asarray(b) for b in bs])
    nblk = -(-T // 256)
    logits, saved = jdisc._run_fwd(
        jdisc._pad_x(jnp.asarray(h), 256, nblk), wk, bk, b=B, nblk=nblk,
        t_signal=T, interpret=True, save=True, block=256, slope=SLOPE)
    twk, tbk = tdisc.pack_disc_weights([torch.from_numpy(k) for k in ks],
                                       [torch.from_numpy(b) for b in bs])
    got, got_saved = tdisc.fused_disc_forward(torch.from_numpy(h), twk, tbk,
                                              slope=SLOPE, save=True)
    _close(got.numpy(), np.asarray(logits)[:, :T, 0], FWD_TOL, "logits")
    want_saved = np.asarray(saved[:, :, 256:256 + T, :64].astype(
        jnp.float32)).transpose(1, 0, 2, 3)
    _close(got_saved.float().numpy(), want_saved, FWD_TOL, "saved")


def test_k3b_reference_matches_pallas_backward(small_block):
    """Both backwards take the same saved streams (so the same LeakyReLU
    masks) and a dlogits that is zero within 80 rows of each end, beyond
    the reach of the Pallas kernel's edge leak (ROADMAP queue 3)."""
    ks, bs = _weights(2)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, T, 64)).astype(np.float32)
    dlog = rng.normal(size=(B, T)).astype(np.float32)
    dlog[:, :80] = dlog[:, -80:] = 0.0
    twk, tbk = tdisc.pack_disc_weights([torch.from_numpy(k) for k in ks],
                                       [torch.from_numpy(b) for b in bs])
    _, saved = tdisc.fused_disc_forward(torch.from_numpy(h), twk, tbk,
                                        slope=SLOPE, save=True)
    dh, dwk, dbk = tdisc.fused_disc_backward(
        saved, torch.from_numpy(dlog), twk, slope=SLOPE, need_dx=True,
        need_weights=True)

    nblk = -(-T // 256)
    sv = np.zeros((B, 9, (nblk + 2) * 256, 128), np.float32)
    sv[:, :, 256:256 + T, :64] = saved.float().numpy().transpose(1, 0, 2, 3)
    _, wkt, _ = jdisc._pack_weights([jnp.asarray(k) for k in ks],
                                    [jnp.asarray(b) for b in bs])
    dlog_pad = np.zeros((B, (nblk + 1) * 256, 128), np.float32)
    dlog_pad[:, 256:256 + T, 0] = dlog
    want_dh, want_dwk, want_dbk = jdisc._run_bwd(
        jnp.asarray(sv, jnp.bfloat16), jnp.asarray(dlog_pad), wkt, b=B,
        nblk=nblk, t_signal=T, interpret=True, block=256, slope=SLOPE)
    _close(dh.numpy(), np.asarray(want_dh)[:, :T, :64], BWD_TOL, "dh")
    _close(dwk.numpy(), np.asarray(want_dwk), BWD_TOL, "dW")
    _close(dbk.numpy(), np.asarray(want_dbk)[:, 0], BWD_TOL, "db")


def test_k3c_reference_matches_pallas_recompute_backward(small_block):
    """K3c's plain version against the Pallas ``_bwd_rc_kernel``: both
    rebuild the layer inputs from h and take the same dlogits, zero within
    80 rows of each end (beyond the Pallas kernel's edge leak)."""
    ks, bs = _weights(10)
    rng = np.random.default_rng(11)
    h = rng.normal(size=(B, T, 64)).astype(np.float32)
    dlog = rng.normal(size=(B, T)).astype(np.float32)
    dlog[:, :80] = dlog[:, -80:] = 0.0
    twk, tbk = tdisc.pack_disc_weights([torch.from_numpy(k) for k in ks],
                                       [torch.from_numpy(b) for b in bs])
    tdisc.fused_disc_backward_recompute.launches = 0
    dh, dwk, dbk = tdisc.fused_disc_backward_recompute(
        torch.from_numpy(h), torch.from_numpy(dlog), twk, tbk, slope=SLOPE,
        need_dx=True, need_weights=True)
    assert tdisc.fused_disc_backward_recompute.launches == 0   # CPU: plain

    nblk = -(-T // 256)
    wk, wkt, bk = jdisc._pack_weights([jnp.asarray(k) for k in ks],
                                      [jnp.asarray(b) for b in bs])
    dlog_pad = np.zeros((B, (nblk + 1) * 256, 128), np.float32)
    dlog_pad[:, 256:256 + T, 0] = dlog
    want_dh, want_dwk, want_dbk = jdisc._run_bwd_rc(
        jdisc._pad_x(jnp.asarray(h), 256, nblk), jnp.asarray(dlog_pad), wk,
        wkt, bk, b=B, nblk=nblk, t_signal=T, interpret=True, block=256,
        slope=SLOPE)
    _close(dh.numpy(), np.asarray(want_dh)[:, :T, :64], BWD_TOL, "dh")
    _close(dwk.numpy(), np.asarray(want_dwk), BWD_TOL, "dW")
    _close(dbk.numpy(), np.asarray(want_dbk)[:, 0], BWD_TOL, "db")


def test_k3c_reference_equals_the_save_path():
    """On the CPU both vjp modes run plain versions that rebuild the same
    streams: K3c's plain version equals K3a(save) + K3b's bitwise, through
    the wrappers and through ``fused_disc_tail``'s autograd Functions, and
    each output alone is what the full call gives."""
    ks, bs = _weights(12)
    rng = np.random.default_rng(13)
    h = torch.from_numpy(rng.normal(size=(B, T, 64)).astype(np.float32))
    dlog = torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32))
    twk, tbk = tdisc.pack_disc_weights([torch.from_numpy(k) for k in ks],
                                       [torch.from_numpy(b) for b in bs])
    rc = tdisc.fused_disc_backward_recompute(h, dlog, twk, tbk, slope=SLOPE,
                                             need_dx=True, need_weights=True)
    _, saved = tdisc.fused_disc_forward(h, twk, tbk, slope=SLOPE, save=True)
    sv = tdisc.fused_disc_backward(saved, dlog, twk, slope=SLOPE,
                                   need_dx=True, need_weights=True)
    for name, got, want in zip(("dh", "dW", "db"), rc, sv):
        assert torch.equal(got, want), name
    dx_only = tdisc.fused_disc_backward_recompute(
        h, dlog, twk, tbk, slope=SLOPE, need_dx=True, need_weights=False)
    w_only = tdisc.fused_disc_backward_recompute(
        h, dlog, twk, tbk, slope=SLOPE, need_dx=False, need_weights=True)
    assert dx_only[1:] == (None, None) and torch.equal(dx_only[0], rc[0])
    assert w_only[0] is None and torch.equal(w_only[1], rc[1])
    with pytest.raises(ValueError, match="nothing to compute"):
        tdisc.fused_disc_backward_recompute(h, dlog, twk, tbk, slope=SLOPE,
                                            need_dx=False,
                                            need_weights=False)

    grads = {}
    for mode in tdisc.VJP_MODES:
        th = h.clone().requires_grad_()
        tk = [torch.tensor(k, requires_grad=True) for k in ks]
        tb = [torch.tensor(b, requires_grad=True) for b in bs]
        out = tdisc.fused_disc_tail(th, tk, tb, negative_slope=SLOPE,
                                    vjp_mode=mode)
        (out[..., 0] * dlog).sum().backward()
        grads[mode] = [th.grad] + [p.grad for p in tk + tb]
    for got, want in zip(grads["recompute"], grads["save"]):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="vjp_mode"):
        tdisc.fused_disc_tail(h, ks, bs, vjp_mode="checkpoint")


def _xla_tail_bf16(h, kernels, biases):
    """The fused forward's rounding in plain JAX ops (bf16 operands)."""
    x = h
    for j, d in enumerate(jdisc.DISC_TAIL_DILS):
        xr = x.astype(jnp.bfloat16).astype(jnp.float32)
        kr = kernels[j].astype(jnp.bfloat16).astype(jnp.float32)
        x = jpwg.conv1d_taps(xr, kr, d, "SAME") + biases[j]
        if j < len(jdisc.DISC_TAIL_DILS) - 1:
            x = jnp.where(x > 0, x, SLOPE * x)
    return x


def test_fused_disc_tail_is_the_transpose_of_its_forward():
    """The port's fused tail (plain versions on the CPU) against autograd
    of the same bf16 forward, over every row including both ends.
    Autograd rounds the cotangent at each bf16 cast and the kernel rounds
    dpre instead, so the two differ by bf16 rounding (measured: 0.008 of
    dh's range, up to 0.011 on the biases)."""
    ks, bs = _weights(4)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(B, T, 64)).astype(np.float32)
    ct = rng.normal(size=(B, T, 1)).astype(np.float32)
    want_out, vjp = jax.vjp(_xla_tail_bf16, jnp.asarray(h),
                            [jnp.asarray(k) for k in ks],
                            [jnp.asarray(b) for b in bs])
    want_dh, want_dk, want_db = vjp(jnp.asarray(ct))
    th = torch.tensor(h, requires_grad=True)
    tk = [torch.tensor(k, requires_grad=True) for k in ks]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    out = tdisc.fused_disc_tail(th, tk, tb, negative_slope=SLOPE)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out.detach().numpy(), want_out, FWD_TOL, "logits")
    _close(th.grad.numpy(), want_dh, BWD_TOL, "dh")
    for j in range(len(ks)):
        _close(tk[j].grad.numpy(), want_dk[j], BWD_TOL, f"dW[{j}]")
        _close(tb[j].grad.numpy(), want_db[j], BWD_TOL, f"db[{j}]")


def _disc(impl, seed, wav, vjp_mode="save"):
    jm = jpwg.PWGDiscriminator(layers=10, conv_channels=64,
                               impl="xla" if impl == "eager" else "pallas",
                               vjp_mode=vjp_mode)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, a in flatten_tree(v).items():
        leaf = key.split("::")[-1]
        if leaf == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif leaf == "bias":
            val = 0.05 * rng.standard_normal(a.shape)
        else:
            val = rng.standard_normal(a.shape) / np.sqrt(a[0].size)
        flat[key] = val.astype(np.float32)
    port = tpwg.PWGDiscriminator(layers=10, conv_channels=64, impl=impl,
                                 vjp_mode=vjp_mode)
    load_flax_params(port, flat)
    return jm, nest_flat(flat), port


def test_discriminator_eager_matches_jax_through_the_bridge():
    wav = (np.random.default_rng(6).normal(size=(2, 300, 1)) * 0.3).astype(
        np.float32)
    jm, variables, port = _disc("eager", 7, wav)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(wav)))
    got = port(torch.from_numpy(wav)).detach().numpy()
    assert got.shape == want.shape == (2, 300, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vjp_mode", ["save", "recompute"])
def test_discriminator_fused_matches_jax_pallas(small_block, vjp_mode):
    """'fused' on CPU tensors runs layer 0 in PyTorch and the plain
    versions of K3a and of the ``vjp_mode``'s backward (K3b or K3c); the
    JAX 'pallas' module with the same ``vjp_mode`` runs the Pallas
    kernels.  Logits, and the gradients of the wav and of every parameter
    (through the bridge) for a cotangent that is zero within 80 rows of
    each end, beyond the Pallas backward's edge leak.  The two forwards
    rebuild the layer inputs in other float32 sum orders, and a
    pre-activation near LeakyReLU's kink then takes the other slope (a
    factor 5 on its dpre): measured, the gradients differ by 4.1-4.2%
    (wav) and up to 7.4% (a bias) in relative L2, as both bf16 paths differ
    from float32 autograd by ~10%.  Held to 2^-3 in relative L2; a wrong
    tap, layer or weight-norm mapping is off by the whole gradient.  The
    kernels' arithmetic is pinned sharper above, on shared inputs."""
    rng = np.random.default_rng(8)
    wav = (rng.normal(size=(2, 500, 1)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(2, 500, 1)).astype(np.float32)
    ct[:, :80] = ct[:, -80:] = 0.0
    jm, variables, port = _disc("fused", 9, wav, vjp_mode)
    want, vjp = jax.vjp(lambda v, x: jm.apply(v, x), variables,
                        jnp.asarray(wav))
    want_dv, want_dwav = vjp(jnp.asarray(ct))
    tdisc.fused_disc_forward.launches = 0
    twav = torch.from_numpy(wav).requires_grad_()
    got = port(twav)
    (got * torch.from_numpy(ct)).sum().backward()
    assert tdisc.fused_disc_forward.launches == 0     # no kernel on the CPU
    _close(got.detach().numpy(), np.asarray(want), FWD_TOL, "logits")
    wanted = tpwg.PWGDiscriminator(layers=10, conv_channels=64)
    load_flax_params(wanted, flatten_tree(want_dv))
    wanted = dict(wanted.named_parameters())
    pairs = [("wav", twav.grad, np.asarray(want_dwav))] + [
        (name, p.grad, wanted[name].detach().numpy())
        for name, p in port.named_parameters()]
    for name, g, w in pairs:
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= MODULE_GRAD_REL_L2, (name, rel)


def test_discriminator_refuses_an_unknown_vjp_mode():
    with pytest.raises(ValueError, match="vjp_mode"):
        tpwg.PWGDiscriminator(impl="fused", vjp_mode="checkpoint")
    assert tpwg.PWGDiscriminator().vjp_mode == "save"   # the JAX default


def test_discriminator_impls_and_support():
    assert tpwg.PWGDiscriminator().supported
    assert not tdisc.fused_disc_supported(1, 1, 3, 8, 64, 1)
    with pytest.raises(ValueError, match="unsupported"):
        tpwg.PWGDiscriminator(layers=8, impl="fused")
    with pytest.raises(ValueError, match="unknown"):
        tpwg.PWGDiscriminator(impl="pallas")
    # 'auto' on CPU tensors is the eager stack: no kernel, same logits
    wav = torch.randn(1, 64, 1, generator=torch.Generator().manual_seed(0))
    auto = tpwg.PWGDiscriminator(impl="auto")
    with torch.no_grad():
        for p in auto.parameters():
            p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    eager = tpwg.PWGDiscriminator(impl="eager")
    eager.load_state_dict(auto.state_dict())
    torch.testing.assert_close(auto(wav), eager(wav), rtol=0, atol=0)
