"""The PWGAN recipe's training run on the PyTorch port against the JAX
package: the YAML ``Config`` and the model-kwargs mapping, the data
loader's batches, snapshots in the shared npz format in both directions,
the snapshot ring, and the recipe CLI and training bench of the port run
in-process on the CPU at tiny widths (``--device cpu``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.data import collate as jcollate
from parakeet_tpu.data import dataloader as jloader
from parakeet_tpu.data.datatable import DataTable as JDataTable
from parakeet_tpu.models import parallel_wavegan as jpwg
from parakeet_tpu.models import pwg_updater as jupd
from parakeet_tpu.ops.stft_loss import multi_resolution_stft_loss as j_mrstft
from parakeet_tpu.training import checkpoint as jckpt
from parakeet_tpu.training import config as jconfig
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu.training.updater import StandardUpdater as JUpdater
from parakeet_tpu_torch.benchmarks import train_pwgan as tbench
from parakeet_tpu_torch.bridge import (RNG_KEY, flax_arrays,
                                       load_flax_params, train_state_arrays)
from parakeet_tpu_torch.models import parallel_wavegan as tpwg
from parakeet_tpu_torch.models import pwg_updater as tupd
from parakeet_tpu_torch.recipes.pwgan import train as trecipe
from parakeet_tpu_torch.recipes.pwgan.dump import write_synthetic_dump
from parakeet_tpu_torch.training import (Config, StandardUpdater,
                                         build_optimizer,
                                         inference_model_kwargs,
                                         resolve_model_kwargs,
                                         seed_everything)
from parakeet_tpu_torch.training import checkpoint as tckpt
from parakeet_tpu_torch.training.checkpoint import SnapshotRing
from parakeet_tpu_torch.utils.device import set_device

torch.set_num_threads(1)

CONF = "recipes/pwgan/conf/default.yaml"
# tiny widths of the recipe: hop 6 (upsample 2 x 3), 4 + 4 layers, small
# STFT losses; the YAML's other keys stay as they are
TINY_OPTS = [
    "n_shift", "6", "batch_size", "2", "batch_max_steps", "180",
    "generator_params.layers", "4", "generator_params.stacks", "2",
    "generator_params.upsample_scales", "[2, 3]",
    "stft_loss_params.fft_sizes", "[64, 128]",
    "stft_loss_params.hop_sizes", "[16, 32]",
    "stft_loss_params.win_lengths", "[32, 64]"]
GEN_CFG = dict(layers=4, stacks=2, residual_channels=32, gate_channels=64,
               skip_channels=32, aux_channels=10, aux_context_window=1,
               upsample_scales=(2, 3))
DISC_CFG = dict(layers=4, conv_channels=16)
STFT_KW = dict(fft_sizes=(64, 128), hop_sizes=(16, 32), win_lengths=(32, 64))
FRAMES = 14


# ------------------------------------------------------------------ config

OVERRIDES = ["batch_size", "6", "generator_params.stack_impl", "xla",
             "discriminator_params.vjp_mode", "recompute",
             "updater.discriminator_train_start_steps", "2",
             "stft_loss_params.fft_sizes", "[64, 128]", "seed", "7"]


def test_config_and_overrides_match_jax(tmp_path):
    got = Config.from_yaml(CONF).merge_opts(OVERRIDES)
    want = jconfig.Config.from_yaml(CONF).merge_opts(OVERRIDES)
    assert got.to_dict() == want.to_dict()
    assert got.discriminator_params.vjp_mode == "recompute"
    assert got.updater.discriminator_train_start_steps == 2
    got.merge({"updater": {"lambda_adv": 2.0}})
    assert got.updater.to_dict() == {"lambda_adv": 2.0,
                                     "discriminator_train_start_steps": 2}
    dumped = tmp_path / "config.yaml"
    got.dump(dumped)
    assert Config.from_yaml(dumped).to_dict() == got.to_dict()
    frozen = Config(got.to_dict()).freeze()
    with pytest.raises(AttributeError, match="frozen"):
        frozen.generator_params.layers = 3
    with pytest.raises(ValueError, match="KEY VALUE"):
        Config().merge_opts(["seed"])


@pytest.mark.parametrize("jax_name,port_name", [
    ("pallas", "fused"), ("xla", "eager"), ("auto", "auto")])
def test_model_kwargs_map_the_jax_impl_names(jax_name, port_name):
    """The repository's YAML runs unchanged: the JAX package's impl names
    resolve to the port's, every other key as the JAX package leaves it."""
    cfg = Config.from_yaml(CONF)
    gen = {**cfg.generator_params, "stack_impl": jax_name}
    disc = {**cfg.discriminator_params, "impl": jax_name,
            "vjp_mode": "recompute"}
    for section, key in ((gen, "stack_impl"), (disc, "impl")):
        got = resolve_model_kwargs(section)
        want = jconfig.resolve_model_kwargs(section)
        assert got.pop(key) == port_name and want.pop(key) == jax_name
        assert got == want
    assert resolve_model_kwargs({"impl": port_name})["impl"] == port_name
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_model_kwargs({"impl": "triton"})
    tpwg.PWGGenerator(**{**resolve_model_kwargs(gen), **GEN_CFG})
    tpwg.PWGDiscriminator(**resolve_model_kwargs(disc))


def test_model_kwargs_take_float32_and_refuse_other_dtypes():
    """float32 is dropped, bfloat16 is flax's compute dtype (as in the JAX
    package), any other dtype raises."""
    assert resolve_model_kwargs({"layers": 3, "dtype": "float32"}) == {
        "layers": 3}
    assert jconfig.resolve_model_kwargs({"dtype": "float32"})["dtype"] \
        == jnp.float32
    assert resolve_model_kwargs({"dtype": "bfloat16"})["dtype"] \
        == torch.bfloat16
    assert jconfig.resolve_model_kwargs({"dtype": "bfloat16"})["dtype"] \
        == jnp.bfloat16
    for dtype in ("fp16", "float16"):
        with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
            resolve_model_kwargs({"dtype": dtype})
    assert inference_model_kwargs({"init_type": "xavier_uniform",
                                   "impl": "xla"}) == {"impl": "eager"}


# ------------------------------------------------------------ data loader

def test_dataloader_batches_match_jax(tmp_path):
    """The recipe's loader on a seeded dump: the JAX loader with the same
    sampler seed and a clip generator seeded (seed, epoch) gives the same
    batches, epoch after epoch."""
    seed = 5
    md = write_synthetic_dump(tmp_path, seed=1, splits={"train": 6},
                              frames=(40, 50), n_mels=10, n_shift=6)
    cfg = Config({"batch_size": 2, "batch_max_steps": 120, "n_shift": 6})
    got_dl = trecipe.build_dataloader(md["train"], cfg, True, 2, seed)
    table = JDataTable.from_jsonl(md["train"], converters={
        "wave": np.load, "feats": np.load})
    sampler = jloader.BatchSampler(len(table), 2, shuffle=True,
                                   drop_last=True, seed=seed)
    clip = jcollate.VocoderClip(batch_max_steps=120, hop_size=6,
                                aux_context_window=2)
    want_dl = jloader.DataLoader(table, sampler, clip)
    assert len(got_dl) == len(want_dl) == 3
    for epoch in (0, 1):
        got_dl.batch_sampler.set_epoch(epoch)
        sampler.set_epoch(epoch)
        clip.rng = np.random.default_rng((seed, epoch))
        got, want = list(got_dl), list(want_dl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"wav", "mel"}
            assert g["wav"].shape == (2, 120) and g["mel"].shape == (2, 24, 10)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    # a second pass over the same epoch draws the same clips
    again = list(got_dl)
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g["wav"], w["wav"])


# ---------------------------------------------------------------- snapshots

def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _gan_batch():
    t = (FRAMES - 2) * 6
    return {"wav": _np(1, 2, t, scale=0.3), "mel": _np(2, 2, FRAMES, 10)}


def _port_state(seed=0):
    g = tpwg.PWGGenerator(stack_impl="eager", **GEN_CFG)
    d = tpwg.PWGDiscriminator(impl="eager", **DISC_CFG)
    state = tupd.init_pwg_train_state(
        g, d, build_optimizer(g.parameters(), "adam", 1e-3),
        build_optimizer(d.parameters(), "adam", 5e-4),
        seed_everything(seed, device="cpu"))
    return state, g, d


def test_jax_snapshot_loads_into_the_port_updater(tmp_path):
    """A snapshot that the JAX ``StandardUpdater.save`` wrote after two
    GAN steps: the port's updater takes its params, Adam moments and
    counts, step and counters leaf by leaf, and reseeds its generator from
    the initial seed (a JAX key cannot cross).  One more generator update
    from the loaded state, on the same noise, gives JAX's objective."""
    batch = _gan_batch()
    wav, mel = batch["wav"], batch["mel"]
    noise = _np(3, *wav.shape, 1)
    jg = jpwg.PWGGenerator(stack_impl="xla", **GEN_CFG)
    jd = jpwg.PWGDiscriminator(impl="xla", **DISC_CFG)
    gv = jg.init(jax.random.PRNGKey(0), jnp.asarray(noise),
                 jnp.asarray(mel))["params"]
    dv = jd.init(jax.random.PRNGKey(1), jnp.asarray(wav[..., None]))["params"]
    gtx, dtx = jbuild("adam", 1e-3), jbuild("adam", 5e-4)
    jstate = jupd.init_pwg_train_state(gv, dv, gtx, dtx,
                                       jax.random.PRNGKey(2))
    jstep = jupd.make_pwg_train_step(jg, jd, gtx, dtx,
                                     discriminator_train_start_steps=0,
                                     **STFT_KW)
    jup = JUpdater(jstep, jstate, [batch, batch])
    jup.update()
    jup.update()
    path = tmp_path / "snapshot_iter_2.npz"
    jup.save(path)

    state, g, d = _port_state(seed=11)
    state.rng.manual_seed(11)
    torch.randn(5, generator=state.rng)          # move it off its seed
    updater = StandardUpdater(tupd.make_pwg_train_step(g, d, **STFT_KW),
                              state, [])
    updater.load(path)
    assert (updater.state.iteration, updater.state.epoch) == (2, 1)
    assert state.step == 2
    flat, _ = jckpt.load_pytree(path)
    got = train_state_arrays(state)
    assert set(got) - {RNG_KEY} == set(flat) - {"rng"}
    for key, want in flat.items():
        if key != "rng":
            np.testing.assert_array_equal(got[key], np.asarray(want), key)
    assert torch.equal(state.rng.get_state(),
                       torch.Generator().manual_seed(11).get_state())

    # one more generator update on both sides, then the objective
    def loss_fn(gp):
        fake = jg.apply({"params": gp}, jnp.asarray(noise), jnp.asarray(mel))
        sc, mag = j_mrstft(fake[..., 0], jnp.asarray(wav), **STFT_KW)
        adv = jnp.mean(jnp.square(jd.apply(
            {"params": jup.train_state.params["discriminator"]}, fake) - 1.0))
        return sc + mag + 4.0 * adv

    jparams = jup.train_state.params["generator"]
    grads = jax.jit(jax.grad(loss_fn))(jparams)
    upd, _ = gtx.update(grads, jup.train_state.opt_state["generator"],
                        jparams)
    want_next = float(jax.jit(loss_fn)(jax.tree_util.tree_map(
        lambda p, u: p + u, jparams, upd)))

    def objective():
        loss, _ = tupd.generator_objective(
            g, d, torch.from_numpy(noise), torch.from_numpy(mel),
            torch.from_numpy(wav), lambda_adv=4.0, disc_on=True,
            stft_kw=STFT_KW)
        return loss

    opt = state.optimizers["generator"]
    opt.zero_grad()
    objective().backward()
    opt.step()
    with torch.no_grad():
        got_next = objective().item()
    np.testing.assert_allclose(got_next, want_next, rtol=1e-4)


def test_port_snapshot_drives_the_jax_generator(tmp_path):
    """A snapshot of the port's updater, after two steps, read by the JAX
    package's ``load_variables``: the JAX generator on those weights gives
    the port generator's output."""
    batch = {k: torch.from_numpy(v) for k, v in _gan_batch().items()}
    state, g, d = _port_state()
    updater = StandardUpdater(
        tupd.make_pwg_train_step(g, d, discriminator_train_start_steps=1,
                                 **STFT_KW), state, [batch, batch])
    updater.update()
    updater.update()
    path = tmp_path / "snapshot_iter_2.npz"
    updater.save(path)
    variables = jckpt.load_variables(path)
    _, meta = jckpt.load_pytree(path)
    assert meta == {"iteration": 2, "epoch": 1}
    noise, mel = _np(4, 2, 72, 1), batch["mel"].numpy()
    jg = jpwg.PWGGenerator(stack_impl="xla", **GEN_CFG)
    want = np.asarray(jg.apply(variables, jnp.asarray(noise),
                               jnp.asarray(mel)))
    with torch.no_grad():
        got = g(torch.from_numpy(noise), batch["mel"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's own reader gives the same weights back
    port_vars = tckpt.load_variables(path)
    fresh = tpwg.PWGGenerator(stack_impl="eager", **GEN_CFG)
    load_flax_params(fresh, tckpt.flatten_nested(port_vars))
    for key, value in flax_arrays(g).items():
        np.testing.assert_array_equal(flax_arrays(fresh)[key], value)


def test_snapshot_ring_prunes_on_rank_0_only(tmp_path):
    """max_size newest snapshots are kept and the ledger written, on rank
    0; another rank keeps the same records in memory and touches no file
    (the JAX ring writes and prunes on every process).  The JAX package
    reads the ledger."""
    ring = SnapshotRing(tmp_path / "r0", max_size=2)
    other = SnapshotRing(tmp_path / "r1", max_size=2, rank=1)
    for it in (2, 4, 6):
        for r in (ring, other):
            r.directory.mkdir(parents=True, exist_ok=True)
            r.path_for(it).write_bytes(b"x")
            r.register(r.path_for(it), it)
    assert sorted(p.name for p in (tmp_path / "r0").iterdir()) == [
        "records.jsonl", "snapshot_iter_4.npz", "snapshot_iter_6.npz"]
    assert sorted(p.name for p in (tmp_path / "r1").iterdir()) == [
        "snapshot_iter_2.npz", "snapshot_iter_4.npz", "snapshot_iter_6.npz"]
    assert [r["iteration"] for r in other.records] == [4, 6]
    for latest in (tckpt.latest_record(tmp_path / "r0"),
                   jckpt.latest_record(tmp_path / "r0"), ring.latest()):
        assert latest["iteration"] == 6
        assert latest["path"] == str(tmp_path / "r0" / "snapshot_iter_6.npz")
    reopened = SnapshotRing(tmp_path / "r0", max_size=2)
    assert [r["iteration"] for r in reopened.records] == [4, 6]
    with pytest.raises(ValueError, match="max_size"):
        SnapshotRing(tmp_path, max_size=0)


def test_save_pytree_is_atomic_and_rank_0_only(tmp_path, monkeypatch):
    path = tmp_path / "a.npz"
    tckpt.save_pytree(path, {"x::y": np.arange(3)}, metadata={"k": 1})
    flat, meta = jckpt.load_pytree(path)
    assert meta == {"k": 1} and np.array_equal(flat["x::y"], np.arange(3))
    assert not list(tmp_path.glob("*.tmp"))
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_pytree(path, {"__metadata__": np.zeros(1)})
    monkeypatch.setattr(tckpt, "process_rank", lambda: 1)
    tckpt.save_pytree(tmp_path / "b.npz", {"x": np.zeros(1)})
    assert not (tmp_path / "b.npz").exists()


# ------------------------------------------------------------- recipe CLI

def _recipe(tmp_path, out, steps, seen):
    md = write_synthetic_dump(tmp_path / "dump", seed=0,
                              splits={"train": 4, "dev": 2},
                              frames=(40, 50), n_shift=6)
    opts = TINY_OPTS + [
        "discriminator_params.impl", "pallas",
        "discriminator_params.vjp_mode", "recompute",
        "updater.discriminator_train_start_steps", "2",
        "save_interval_steps", "2", "eval_interval_steps", "2",
        "num_snapshots", "2", "train_max_steps", str(steps)]
    seen.clear()
    return trecipe.main(["--config", CONF,
                         "--train-metadata", str(md["train"]),
                         "--dev-metadata", str(md["dev"]),
                         "--output-dir", str(tmp_path / out),
                         "--device", "cpu", "--opts", *opts])


def test_recipe_resumes_bitwise(tmp_path, monkeypatch):
    """The recipe on the CPU: 4 steps (2 epochs of 2 batches), then a
    second run to 6 resumes from the newest snapshot at iteration 4 and
    runs steps 4-5 only; its metrics equal a straight 6-step run's
    bitwise (the same clips, noise and arithmetic).  Evaluation is
    reported, num_snapshots files and the ledger are left, and the
    discriminator trains in vjp_mode='recompute' (its plain versions on
    the CPU) from step 2."""
    seen = []
    make = trecipe.make_pwg_train_step

    def counting(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(state, batch):
            seen.append(state.step)
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(trecipe, "make_pwg_train_step", counting)
    first = _recipe(tmp_path, "resumed", 4, seen)
    assert seen == [0, 1, 2, 3]
    d = first.updater.train_state.modules["discriminator"]
    assert (d.impl, d.vjp_mode) == ("fused", "recompute")
    resumed = _recipe(tmp_path, "resumed", 6, seen)
    assert seen == [4, 5]
    straight = _recipe(tmp_path, "straight", 6, seen)
    assert seen == list(range(6))
    for trainer in (resumed, straight):
        assert (trainer.updater.state.iteration,
                trainer.updater.state.epoch) == (6, 3)
        ckpt = trainer.out / "checkpoints"
        assert sorted(p.name for p in ckpt.iterdir()) == [
            "records.jsonl", "snapshot_iter_4.npz", "snapshot_iter_6.npz"]
        assert [json.loads(line)["iteration"] for line in
                (ckpt / "records.jsonl").read_text().splitlines()] == [4, 6]
    got = {k: float(v) for k, v in resumed.observation.items()}
    want = {k: float(v) for k, v in straight.observation.items()}
    assert got == want
    assert {"train/discriminator_loss", "eval/generator_loss",
            "eval/adversarial_loss"} <= got.keys()
    assert all(np.isfinite(v) for v in got.values())
    assert got["train/discriminator_loss"] > 0
    assert (tmp_path / "straight" / "config.yaml").exists()


def test_recipe_trains_the_fused_stack_at_residual_width_128(tmp_path,
                                                            monkeypatch):
    """The recipe at ``--opts generator_params.residual_channels 128
    generator_params.gate_channels 256 generator_params.skip_channels
    128``, which JAX's fused stack takes (layers and clip cut by
    TINY_OPTS): the YAML's stack_impl builds a 'fused' ResidualStack at
    that width, step 0 trains it through the K2 route, step 1 (the
    discriminator from step 1) is a GAN step that also regenerates the
    fake through K1 (their plain versions on the CPU), and the losses are
    finite."""
    calls = {"fused_residual_stack_train": 0, "fused_residual_stack": 0}
    for name in calls:
        real = getattr(tpwg, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(tpwg, name, counted)
    md = write_synthetic_dump(tmp_path / "dump", seed=0,
                              splits={"train": 4, "dev": 2},
                              frames=(40, 50), n_shift=6)
    opts = TINY_OPTS + [
        "generator_params.residual_channels", "128",
        "generator_params.gate_channels", "256",
        "generator_params.skip_channels", "128",
        "updater.discriminator_train_start_steps", "1",
        "save_interval_steps", "2", "eval_interval_steps", "2",
        "train_max_steps", "2"]
    trainer = trecipe.main(["--config", CONF,
                            "--train-metadata", str(md["train"]),
                            "--dev-metadata", str(md["dev"]),
                            "--output-dir", str(tmp_path / "cr128"),
                            "--device", "cpu", "--opts", *opts])
    stack = trainer.updater.train_state.modules["generator"].stack
    assert (stack.impl, stack.residual_channels, stack.skip_channels) == (
        "fused", 128, 128)
    assert stack.conv_kernel.shape == (4, 3, 128, 256)
    assert calls["fused_residual_stack_train"] == 2
    assert calls["fused_residual_stack"] >= 1
    obs = {k: float(v) for k, v in trainer.observation.items()}
    assert {"train/discriminator_loss", "eval/generator_loss"} <= obs.keys()
    assert all(np.isfinite(v) for v in obs.values())


def test_recipe_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        set_device("cuda")
    with pytest.raises(SystemExit):
        trecipe.main(["--config", CONF, "--train-metadata", "x",
                      "--dev-metadata", "y", "--device", "tpu"])


def test_entry_points_default_to_the_card():
    import inspect
    assert inspect.signature(seed_everything).parameters[
        "device"].default == "cuda"
    import argparse
    from parakeet_tpu_torch.utils.device import add_device_arg
    parser = argparse.ArgumentParser()
    add_device_arg(parser)
    assert parser.parse_args([]).device == "cuda"


# ------------------------------------------------------------------ bench

@pytest.mark.parametrize("disc_vjp", ["save", "recompute"])
def test_train_bench_prints_its_json_line(disc_vjp, capsys, tmp_path):
    records = tbench.main(["--device", "cpu", "--batch-sizes", "1",
                           "--iters", "1", "--disc-impl", "fused",
                           "--disc-vjp", disc_vjp,
                           "--profile", str(tmp_path),
                           "--opts", *TINY_OPTS,
                           "discriminator_params.layers", "10"])
    for suffix in ("json", "txt"):
        trace = tmp_path / f"train_pwgan_bs1_{disc_vjp}.{suffix}"
        assert trace.stat().st_size > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == records
    (rec,) = records
    assert rec["metric"] == "pwgan_train_avg_ips" and rec["value"] > 0
    assert rec["unit"] == "sequences/sec" and rec["batch_size"] == 1
    assert (rec["disc_vjp"], rec["backend"], rec["dtype"]) == (
        disc_vjp, "cpu", "float32")
    assert "mfu" not in rec
