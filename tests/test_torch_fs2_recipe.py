"""The FastSpeech2 recipe slice of the PyTorch port against the JAX package:
the collate function, the batch sampler's kept last batch, the
``init_type`` initializer, the "concat" speaker integration, the recipe
YAMLs, the recipe CLI on the CPU (resume and its first loss against the
JAX pipeline) and the training bench.  Inputs are drawn with numpy from a
seed; the CLI runs at tiny widths through ``--opts``.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.data import collate as jcollate
from parakeet_tpu.data import dataloader as jloader
from parakeet_tpu.data.datatable import DataTable as JDataTable
from parakeet_tpu.models import fs2_updater as jupd
from parakeet_tpu.models.fastspeech2 import FastSpeech2 as JFS2
from parakeet_tpu.models.fastspeech2 import fastspeech2_loss as j_loss
from parakeet_tpu.nn.initializer import initialize_pytree
from parakeet_tpu.training.checkpoint import flatten_tree, nest_flat
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu_torch.benchmarks import train_fastspeech2 as tbench
from parakeet_tpu_torch.bridge import _flax_leaves, flax_arrays, \
    load_flax_params
from parakeet_tpu_torch.data import (BatchSampler, fastspeech2_batch_fn)
from parakeet_tpu_torch.models import FastSpeech2, fastspeech2_loss
from parakeet_tpu_torch.nn import initializer as tinit
from parakeet_tpu_torch.recipes.fastspeech2 import train as trecipe
from parakeet_tpu_torch.recipes.fastspeech2.dump import write_synthetic_dump
from parakeet_tpu_torch.training import Config

torch.set_num_threads(1)

CONF_DIR = Path(__file__).resolve().parents[1] / "recipes" / "fastspeech2" \
    / "conf"
CONF = CONF_DIR / "default.yaml"
WIDTHS = dict(adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
              postnet_layers=2, postnet_chans=8, duration_predictor_chans=8,
              pitch_predictor_chans=8, energy_predictor_chans=8)
TINY_OPTS = [x for k, v in WIDTHS.items() for x in (f"model.{k}", str(v))]
DROPOUTS = (
    "duration_predictor_dropout_rate", "energy_predictor_dropout",
    "energy_embed_dropout", "pitch_predictor_dropout", "pitch_embed_dropout",
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate",
    "transformer_dec_attn_dropout_rate", "postnet_dropout_rate")
NO_DROPOUT_OPTS = [x for k in DROPOUTS for x in (f"model.{k}", "0.0")]
BATCH_KEYS = ("text", "text_lengths", "speech", "speech_lengths",
              "durations", "pitch", "energy")


def _examples(seed, n, spk=False, spk_emb=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = int(rng.integers(5, 21))
        frames = int(rng.integers(30, 101))
        x = {"text": rng.integers(2, 40, tokens).tolist(),
             "speech": rng.standard_normal((frames, 8)).astype(np.float32),
             "durations": rng.integers(1, 9, tokens).tolist(),
             "pitch": rng.standard_normal((tokens, 1)).astype(np.float32),
             "energy": rng.standard_normal((tokens, 1)).astype(np.float32)}
        if spk:
            x["spk_id"] = int(rng.integers(0, 5))
        if spk_emb:
            x["spk_emb"] = rng.standard_normal(6).astype(np.float32)
        out.append(x)
    return out


@pytest.mark.parametrize("spk,spk_emb", [(False, False), (True, False),
                                         (False, True)])
def test_fastspeech2_batch_fn_matches_jax_bitwise(spk, spk_emb):
    """The same examples give the JAX collate's keys, dtypes, shapes and
    values bit for bit (text padded to 16, frames to 64)."""
    examples = _examples(1, 5, spk, spk_emb)
    got = fastspeech2_batch_fn(examples, spk=spk)
    want = jcollate.fastspeech2_batch_fn(examples, spk=spk)
    assert got.keys() == want.keys()
    assert ("spk_id" in got) == spk and ("spk_emb" in got) == spk_emb
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["text"].shape[1] % 16 == 0 and got["speech"].shape[1] % 64 == 0


@pytest.mark.parametrize("size,batch,shuffle,drop_last", [
    (40, 16, False, False), (40, 16, True, False), (40, 16, True, True),
    (64, 16, False, False), (7, 3, True, False)])
def test_batch_sampler_keeps_the_last_batch_as_jax(size, batch, shuffle,
                                                    drop_last):
    """``drop_last=False`` keeps the partial last batch (the FastSpeech2
    recipe's dev set): the port's batches and len are JAX's, by epoch."""
    for epoch in (0, 3):
        got = BatchSampler(size, batch, shuffle=shuffle, seed=5,
                           drop_last=drop_last)
        want = jloader.BatchSampler(size, batch, shuffle=shuffle,
                                    drop_last=drop_last, seed=5)
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want) and len(got) == len(want)
    assert BatchSampler(size, batch).drop_last


SPK_CFG = dict(idim=20, odim=8, **WIDTHS, num_speakers=3, spk_embed_dim=6,
               spk_embed_integration_type="concat",
               **dict.fromkeys(DROPOUTS, 0.0))


@pytest.fixture(scope="module")
def jax_fs2():
    """(JAX model with speakers, concat, its variables, a batch)."""
    jm = JFS2(attn_impl="dense", **SPK_CFG)
    batch = _model_batch(1)
    v = jax.jit(lambda k: jm.init(
        {"params": k}, *[jnp.asarray(batch[n]) for n in BATCH_KEYS],
        spk_id=jnp.asarray(batch["spk_id"]), deterministic=False))(
        jax.random.PRNGKey(0))
    return jm, v, batch


def _model_batch(seed, b=2, t_text=12, frames=64):
    rng = np.random.default_rng(seed)
    lengths, frame_lengths = (12, 9), (64, 50)
    text = np.zeros((b, t_text), np.int64)
    durations = np.zeros((b, t_text), np.int64)
    for i, (n, f) in enumerate(zip(lengths, frame_lengths)):
        text[i, :n] = rng.integers(1, 20, n)
        durations[i, :n] = 1 + rng.multinomial(f - n, np.full(n, 1.0 / n))
    return {"text": text, "text_lengths": np.asarray(lengths),
            "speech": rng.standard_normal((b, frames, 8)).astype(np.float32),
            "speech_lengths": np.asarray(frame_lengths),
            "durations": durations,
            "pitch": rng.standard_normal((b, t_text, 1)).astype(np.float32),
            "energy": rng.standard_normal((b, t_text, 1)).astype(np.float32),
            "spk_id": np.array([2, 0])}


def _jax_bound(shape, init_type):
    """The largest magnitude jax.nn.initializers' scheme draws for a flax
    leaf of ``shape`` (fans with the last axis out, the one before it in,
    the rest a receptive field): the uniform's limit sqrt(3 var), or the
    truncated normal's 2 sqrt(var) / 0.8796."""
    scale, mode, dist = {"xavier_uniform": (1, "avg", "uniform"),
                         "xavier_normal": (1, "avg", "normal"),
                         "kaiming_uniform": (2, "in", "uniform"),
                         "kaiming_normal": (2, "in", "normal")}[init_type]
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    var = scale / (fan_in if mode == "in" else (fan_in + fan_out) / 2)
    return (math.sqrt(3 * var) if dist == "uniform"
            else 2 * math.sqrt(var) / .87962566103423978)


@pytest.mark.parametrize("init_type", sorted(tinit.INIT_SCHEMES))
def test_initializer_redraws_jax_set_within_its_bounds(init_type, jax_fs2):
    """``initialize_`` redraws exactly the parameters whose flax leaves
    ``initialize_pytree`` redraws (every rank >= 2 leaf: kernels,
    embeddings, the attention projections' (heads, dk) biases), named
    through the bridge; the port's flax shapes are the JAX leaves'; every
    draw lies within its scheme's bound and the larger tensors reach near
    it; the same generator seed redraws the same values; every other
    parameter is left as it was."""
    _, v, _ = jax_fs2
    tm = FastSpeech2(attn_impl="dense", **SPK_CFG)
    flat = flatten_tree({"params": v["params"]})
    jax_set = {k for k, a in flat.items() if np.ndim(a) >= 2}
    if init_type == "xavier_uniform":
        redrawn_j = flatten_tree({"params": initialize_pytree(
            v["params"], jax.random.PRNGKey(1), init_type)})
        assert jax_set == {k for k in flat
                           if not np.array_equal(flat[k], redrawn_j[k])}
    names = {key: name for key, name, _, _ in _flax_leaves(tm)}
    shapes = tinit.flax_shapes(tm)
    for key, a in flat.items():
        assert shapes[names[key]] == np.shape(a), key
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    redrawn = tinit.initialize_(tm, torch.Generator().manual_seed(3),
                                init_type)
    assert sorted(redrawn) == sorted(names[k] for k in jax_set)
    assert any(n.endswith("self_attn.q.bias") for n in redrawn)
    normal = "normal" in init_type
    for name, p in tm.named_parameters():
        if name not in redrawn:
            assert torch.equal(p, before[name]), name
            continue
        bound = _jax_bound(shapes[name], init_type)
        peak = p.abs().max().item()
        assert peak <= bound * (1 + 1e-6), name
        if p.numel() >= (1000 if normal else 100):
            assert peak >= (0.9 if normal else 0.95) * bound, name
    again = FastSpeech2(attn_impl="dense", **SPK_CFG)
    tinit.initialize_(again, torch.Generator().manual_seed(3), init_type)
    for name in redrawn:
        assert torch.equal(dict(again.named_parameters())[name],
                           dict(tm.named_parameters())[name]), name
    with pytest.raises(ValueError, match="Unknown initialization"):
        tinit.initialize_(tm, torch.Generator(), "orthogonal")


def test_concat_speaker_integration_matches_jax(jax_fs2):
    """The "concat" integration (aishell3.yaml, vctk.yaml):
    spk_projection(concat([hs, tile(l2norm(spk_emb))])) maps adim +
    spk_embed_dim to adim.  Its forward and every gradient against JAX's
    at tiny widths with the JAX weights bridged over (the wider
    spk_projection kernel included), every dropout 0, BatchNorm on batch
    statistics."""
    jm, v, batch = jax_fs2
    tm = FastSpeech2(attn_impl="dense", **SPK_CFG)
    rng = np.random.default_rng(5)
    flat = {k: (rng.standard_normal(np.shape(a)) * 0.3).astype(np.float32)
            if k.startswith("params") else np.asarray(a)
            for k, a in flatten_tree(v).items()}
    assert flat["params::spk_projection::kernel"].shape == (16 + 6, 16)
    load_flax_params(tm, flat)
    variables = nest_flat(flat)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *[jbatch[k] for k in BATCH_KEYS],
                          spk_id=jbatch["spk_id"], deterministic=False,
                          mutable=["batch_stats"])
        return j_loss(out, jbatch)["loss"], out

    (want_loss, want_out), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    out = tm(*[tb[k] for k in BATCH_KEYS], spk_id=tb["spk_id"],
             deterministic=False)
    loss = fastspeech2_loss(out, tb)["loss"]
    loss.backward()
    for key in ("before_outs", "after_outs", "d_outs", "p_outs"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(want_out[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = flatten_tree({"params": want_g})
    names = {key: name for key, name, _, _ in _flax_leaves(tm)}
    params = dict(tm.named_parameters())
    want_model = FastSpeech2(attn_impl="dense", **SPK_CFG)
    load_flax_params(want_model, {**flat, **grads})
    wanted = dict(want_model.named_parameters())
    for key in grads:
        name = names[key]
        w, g = wanted[name].detach(), params[name].grad
        err = (g - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-6, (name, err)


@pytest.mark.parametrize("yaml_name", ["default", "ljspeech", "aishell3",
                                       "vctk"])
def test_every_recipe_yaml_builds_the_port_model(yaml_name):
    """Each FastSpeech2 YAML builds the port's model at its full widths
    (adim 384 over 2 heads: dk 192, which K4 takes) with init_type
    applied; the multi-speaker ones with the concat integration's wider
    projection."""
    cfg = Config.from_yaml(CONF_DIR / f"{yaml_name}.yaml")
    multi = "spk_embed_dim" in cfg.model
    model = trecipe.build_model(cfg, 60, 80, 10 if multi else None)
    assert model.encoder.layer_0.self_attn.n_heads == 2
    assert cfg.model.adim // cfg.model.aheads == 192
    if multi:
        assert model.spk_projection.weight.shape == (384, 384 + 256)
        assert model.spk_embedding_table.weight.shape == (10, 256)
    # biases start at flax's zeros, unless init_type redraws them
    assert torch.count_nonzero(model.feat_out.bias) == 0
    assert torch.count_nonzero(
        model.encoder.layer_0.self_attn.q.bias) > 0


def _dump(tmp_path, speakers=None):
    return write_synthetic_dump(tmp_path / "dump", seed=0,
                                splits={"train": 6, "dev": 5},
                                frames=(30, 60), phones=(5, 12),
                                speakers=speakers)


def _run(md, out, epochs, opts=(), config=CONF, speakers=False):
    argv = ["--config", str(config), "--train-metadata", str(md["train"]),
            "--dev-metadata", str(md["dev"]), "--output-dir", str(out),
            "--phones-dict", str(md["phones"]), "--device", "cpu"]
    if speakers:
        argv += ["--speaker-dict", str(md["speakers"])]
    return trecipe.main(argv + ["--opts", *TINY_OPTS, "batch_size", "2",
                                "max_epoch", str(epochs), *opts])


def test_synthetic_dump_is_in_the_recipe_format(tmp_path):
    md = _dump(tmp_path, speakers=4)
    rows = [json.loads(line) for line in
            md["train"].read_text().splitlines()]
    assert len(rows) == 6
    n_phones = len(md["phones"].read_text().splitlines())
    for row in rows:
        speech = np.load(row["speech"])
        assert speech.shape == (row["speech_lengths"], 80)
        assert sum(row["durations"]) == speech.shape[0]
        assert min(row["durations"]) >= 1
        assert len(row["text"]) == len(row["durations"])
        assert all(2 <= t < n_phones for t in row["text"])
        for key in ("pitch", "energy"):
            assert np.load(row[key]).shape == (len(row["text"]), 1)
        assert 0 <= row["spk_id"] < 4
    assert len(md["speakers"].read_text().splitlines()) == 4
    again = _dump(tmp_path / "again", speakers=4)
    assert again["train"].read_text().replace(str(tmp_path / "again"), "") \
        == md["train"].read_text().replace(str(tmp_path), "")


def test_recipe_resumes_bitwise(tmp_path, monkeypatch):
    """The recipe on the CPU with the YAML's dropout: 1 epoch (3 steps of
    2; the dev set's 5 utterances in 3 batches, the last of 1), then a
    second run to 2 epochs resumes from the snapshot at iteration 3 and
    runs steps 3-5 only; its last train and eval metrics equal a straight
    2-epoch run's bitwise."""
    seen = []
    make = trecipe.make_fs2_train_step

    def counting(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(state, batch):
            seen.append(state.step)
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(trecipe, "make_fs2_train_step", counting)
    md = _dump(tmp_path)
    first = _run(md, tmp_path / "resumed", 1)
    assert seen == [0, 1, 2]
    seen.clear()
    resumed = _run(md, tmp_path / "resumed", 2)
    assert seen == [3, 4, 5]
    seen.clear()
    straight = _run(md, tmp_path / "straight", 2)
    assert seen == list(range(6))
    assert first.updater.state.iteration == 3
    for trainer in (resumed, straight):
        assert (trainer.updater.state.iteration,
                trainer.updater.state.epoch) == (6, 2)
        ckpt = trainer.out / "checkpoints"
        assert sorted(p.name for p in ckpt.iterdir()) == [
            "records.jsonl", "snapshot_iter_3.npz", "snapshot_iter_6.npz"]
    got = {k: float(v) for k, v in resumed.observation.items()}
    want = {k: float(v) for k, v in straight.observation.items()}
    assert got == want
    assert {"train/loss", "eval/loss", "eval/duration_loss"} <= got.keys()
    assert all(math.isfinite(x) for x in got.values())


def test_recipe_first_loss_matches_the_jax_pipeline(tmp_path, monkeypatch):
    """Every dropout 0: the CLI's first step's loss against the JAX
    recipe's pipeline on the same dump (DataTable -> BatchSampler
    (shuffled, seed 0) -> fastspeech2_batch_fn -> make_fs2_train_step)
    from the port's initial weights bridged over, with speakers
    (aishell3.yaml's concat integration)."""
    seen = []
    make = trecipe.make_fs2_train_step

    def recording(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def wrapped(state, batch):
            # copies: on the CPU flax_arrays may share the parameters'
            # memory, which the step updates
            seen.append(({k: a.copy() for k, a in
                          flax_arrays(model).items()},
                         {k: v.numpy().copy() for k, v in batch.items()}))
            state, metrics = step(state, batch)
            seen[-1] += (float(metrics["loss"]),)
            return state, metrics
        return wrapped

    monkeypatch.setattr(trecipe, "make_fs2_train_step", recording)
    md = _dump(tmp_path, speakers=4)
    trainer = _run(md, tmp_path / "exp", 1, NO_DROPOUT_OPTS,
                   config=CONF_DIR / "aishell3.yaml", speakers=True)
    weights, batch, loss = seen[0]
    model = trainer.updater.train_state.modules["model"]
    assert model.spk_embed_integration_type == "concat"

    table = JDataTable.from_jsonl(md["train"], converters={
        "speech": np.load, "pitch": np.load, "energy": np.load})
    sampler = jloader.BatchSampler(len(table), 2, shuffle=True,
                                   drop_last=True)
    first = jcollate.fastspeech2_batch_fn(
        [table[i] for i in next(iter(sampler))], spk=True)
    assert first.keys() == batch.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], batch[k], err_msg=k)
    cfg = Config.from_yaml(CONF_DIR / "aishell3.yaml").merge_opts(
        TINY_OPTS + NO_DROPOUT_OPTS)
    kwargs = dict(cfg.model)
    kwargs.pop("init_type")
    jm = JFS2(idim=len(md["phones"].read_text().splitlines()), odim=80,
              num_speakers=4, **kwargs)
    jbatch = {k: jnp.asarray(v) for k, v in first.items()}
    tx = jbuild("adam", 1e-3)
    state = jupd.init_fs2_train_state(jm, tx, jax.random.PRNGKey(0),
                                      jbatch)
    shapes = {k: np.shape(a) for k, a in flatten_tree(
        {"params": state.params, "batch_stats": state.batch_stats}).items()}
    assert shapes.keys() == weights.keys()
    variables = nest_flat({k: jnp.asarray(a.reshape(shapes[k]))
                           for k, a in weights.items()})
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    _, metrics = jupd.make_fs2_train_step(jm, tx)(state, jbatch)
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)


def test_train_bench_prints_its_json_line(capsys):
    record = tbench.main(["--device", "cpu", "--iters", "1",
                          "--batch-size", "2", "--text-len", "8",
                          "--frames", "24", "--attn-impl", "flash"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == record
    assert record["metric"] == "fastspeech2_train_avg_ips"
    assert record["value"] > 0 and record["unit"] == "sequences/sec"
    assert (record["batch_size"], record["attn_impl"], record["backend"],
            record["dtype"]) == (2, "flash", "cpu", "float32")
    # flax's mixed precision runs (float32 parameters, bf16 products);
    # the TPU's device generator stays refused
    bf16 = tbench.main(["--device", "cpu", "--iters", "1", "--batch-size",
                        "2", "--text-len", "8", "--frames", "24",
                        "--attn-impl", "flash", "--dtype", "bfloat16"])
    assert bf16["dtype"] == "bfloat16" and bf16["value"] > 0
    with pytest.raises(NotImplementedError):
        tbench.main(["--device", "cpu", "--rng", "rbg"])
