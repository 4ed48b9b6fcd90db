"""The GE2E and voice-cloning recipes of the PyTorch port against the JAX
package's CLIs, on the CPU: GE2E's preprocess -> inference chain on
seeded ``formant_utterance`` wavs (the mels bit for bit, the embeddings
within 1e-5 on one tiny JAX checkpoint), the GE2E train CLI, the AISHELL-3
``extract_mel.py`` and ``chinese_g2p.py`` outputs bit for bit, the
AISHELL-3 train CLI's first loss against the JAX pipeline, the
conditioned ``Tacotron2.infer`` on text padded to (1, 128) against JAX's,
and ``voice_cloning.py`` end to end (its GE2E embedding against JAX's
``embed_reference``, its mel against the JAX CLI's, a wav with WaveFlow).

The JAX CLIs run in this process (``sys.argv`` patched).  Every dropout
rate of a Tacotron2 compared with JAX is 0, the prenet's included: the
two packages' random streams differ.
"""
import json
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_tpu.data import dataloader as jloader
from parakeet_tpu.data.datatable import DataTable as JDataTable
from parakeet_tpu.models import ConditionalWaveFlow as JWaveFlow
from parakeet_tpu.models import LSTMSpeakerEncoder as JEncoder
from parakeet_tpu.models import tacotron2_updater as jupd
from parakeet_tpu.models.tacotron2 import Tacotron2 as JT2
from parakeet_tpu.training.checkpoint import (flatten_tree, load_pytree,
                                              nest_flat, save_pytree)
from parakeet_tpu.training.optimizer import build_optimizer as jbuild
from parakeet_tpu_torch.audio import save_wav
from parakeet_tpu_torch.audio.synthetic import formant_utterance
from parakeet_tpu_torch.bridge import (flax_arrays, load_checkpoint_params,
                                       load_flax_params)
from parakeet_tpu_torch.models import LSTMSpeakerEncoder, Tacotron2
from parakeet_tpu_torch.recipes.ge2e import inference as ge2e_inference
from parakeet_tpu_torch.recipes.ge2e import preprocess as ge2e_preprocess
from parakeet_tpu_torch.recipes.ge2e import train as ge2e_train
from parakeet_tpu_torch.recipes.ge2e.dump import write_synthetic_mels
from parakeet_tpu_torch.recipes.tacotron2 import train as t2_train
from parakeet_tpu_torch.recipes.tacotron2_aishell3 import (chinese_g2p,
                                                           extract_mel)
from parakeet_tpu_torch.recipes.tacotron2_aishell3 import train as vc_train
from parakeet_tpu_torch.recipes.tacotron2_aishell3 import \
    voice_cloning
from parakeet_tpu_torch.recipes.tacotron2_aishell3.dump import \
    write_synthetic_dump
from parakeet_tpu_torch.recipes.tacotron2_aishell3.voice_cloning import \
    ClonedSpeech
from parakeet_tpu_torch.training import Config
from test_torch_ge2e import _jax_recipe
from test_torch_speedyspeech import _close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VC_CONF = ROOT / "recipes" / "tacotron2_aishell3" / "conf" / "default.yaml"
# a Tacotron2 as tiny as tests/test_recipes_smoke.py's, conditioned on a
# 256-wide GE2E embedding, with every dropout 0
T2_TINY = dict(d_mels=10, d_encoder=16, encoder_conv_layers=1,
               encoder_kernel_size=3, d_prenet=8, d_attention_rnn=16,
               d_decoder_rnn=16, attention_filters=4, attention_kernel_size=5,
               d_attention=8, d_postnet=8, postnet_kernel_size=3,
               postnet_conv_layers=2)
NO_DROPOUT = dict.fromkeys(("p_encoder_dropout", "p_prenet_dropout",
                            "p_attention_dropout", "p_decoder_dropout",
                            "p_postnet_dropout"), 0.0)
T2_OPTS = [x for k, v in {**T2_TINY, **NO_DROPOUT}.items()
           for x in (f"model.{k}", str(v))] + ["batch_size", "2"]


def _run_jax(monkeypatch, name, *args):
    """The JAX recipe ``name``'s ``main`` on ``args``, in this process."""
    mod = _jax_recipe(name)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in args])
    return mod.main()


def _wav_tree(root, sr, speakers, per_speaker, name=lambda s, i: f"u{i}"):
    """Seeded formant utterances, ``per_speaker`` under each speaker's
    directory."""
    for s, spk in enumerate(speakers):
        d = root / spk
        d.mkdir(parents=True)
        for i in range(per_speaker):
            utt = formant_utterance(sr=sr, hop_length=sr // 100,
                                    f0_start=120.0 + 60 * s,
                                    seed=10 * s + i)
            save_wav(d / f"{name(spk, i)}.wav", utt["wav"], sr)
    return root


def _same_trees(a, b):
    files = sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    assert files and files == sorted(p.relative_to(b)
                                     for p in b.rglob("*.npy"))
    for rel in files:
        x, y = np.load(a / rel), np.load(b / rel)
        assert x.dtype == y.dtype and np.array_equal(x, y), rel
    return files


def test_ge2e_preprocess_inference_chain_matches_jax(tmp_path, monkeypatch):
    """The setting of tests/test_recipes_smoke.py's chain (2 speakers x 2
    utterances at 16 kHz, ``--min-frames 40``, a JAX encoder of 32 x 3
    layers over 40 bands) on formant utterances: the port's mels equal the
    JAX CLI's bit for bit, and the port's embeddings of them are within
    1e-5 of the JAX CLI's (which pads the partials to a multiple of 8)."""
    wavs = _wav_tree(tmp_path / "wavs", 16000, ("spk_a", "spk_b"), 2)
    _run_jax(monkeypatch, "ge2e/preprocess.py", "--input", wavs, "--output",
             tmp_path / "jax_mels", "--min-frames", 40)
    ge2e_preprocess.main(["--input", str(wavs), "--output",
                          str(tmp_path / "mels"), "--min-frames", "40"])
    assert len(_same_trees(tmp_path / "mels", tmp_path / "jax_mels")) == 4

    enc = JEncoder(n_mels=40, hidden_size=32, output_size=32)
    v = enc.init(jax.random.PRNGKey(0), jnp.zeros((2, 160, 40)))
    ckpt = tmp_path / "ge2e.npz"
    save_pytree(ckpt, {"params": v["params"]})
    _run_jax(monkeypatch, "ge2e/inference.py", "--checkpoint", ckpt,
             "--input", tmp_path / "mels", "--output", tmp_path / "jax_emb",
             "--hidden-size", 32, "--output-size", 32, "--device", "cpu")
    got = ge2e_inference.main([
        "--checkpoint", str(ckpt), "--input", str(tmp_path / "mels"),
        "--output", str(tmp_path / "emb"), "--hidden-size", "32",
        "--output-size", "32", "--device", "cpu"])
    assert len(got) == 4
    for rel, emb in got.items():
        want = np.load(tmp_path / "jax_emb" / rel)
        assert emb.shape == want.shape == (32,)
        np.testing.assert_allclose(emb, want, atol=1e-5)
        np.testing.assert_array_equal(np.load(tmp_path / "emb" / rel), emb)


def test_ge2e_train_cli(tmp_path):
    """3 iterations of the CLI on a seeded mel tree at its default widths
    (2 speakers x 2 utterances of 20 frames a batch), a snapshot at
    iteration 2: finite metrics, a snapshot in the JAX format whose params
    the JAX encoder applies, as the port's after 2 steps would."""
    root = write_synthetic_mels(tmp_path / "mels", seed=1, speakers=3,
                                utterances=3, frames=(15, 40), n_mels=8)
    state, metrics = ge2e_train.main([
        "--data-root", str(root), "--output-dir", str(tmp_path / "exp"),
        "--speakers-per-batch", "2", "--utterances-per-speaker", "2",
        "--frames", "20", "--n-mels", "8", "--max-iteration", "3",
        "--save-interval", "2", "--device", "cpu"])
    assert state.step == 3
    assert all(math.isfinite(float(v)) for v in metrics.values())
    (snap,) = (tmp_path / "exp" / "checkpoints").glob("*.npz")
    assert snap.name == "snapshot_iter_2.npz"
    flat, meta = load_pytree(snap)
    assert meta == {"iteration": 2} and int(flat["step"]) == 2
    params = nest_flat({k[len("params::"):]: v for k, v in flat.items()
                        if k.startswith("params::")})
    x = np.random.default_rng(2).standard_normal((3, 20, 8)).astype(
        np.float32)
    want = JEncoder(n_mels=8).apply({"params": params}, jnp.asarray(x))
    model = LSTMSpeakerEncoder(n_mels=8)
    load_checkpoint_params(model, snap)
    _close(model(torch.from_numpy(x)).detach(), want, what="embeddings")


def _aishell3_tree(tmp_path):
    """Two AISHELL-3 speakers' wavs (22.05 kHz) and a label file in both
    formats, with one line whose syllable the lexicon lacks and one whose
    mel is missing."""
    wavs = _wav_tree(tmp_path / "wav", 22050, ("SSB0001", "SSB0002"), 2,
                     name=lambda spk, i: f"{spk}{i:04d}")
    label = tmp_path / "label_train-set.txt"
    label.write_text("\n".join([
        "# AISHELL-3 labels", "",
        "SSB00010000|你好|ni3 hao3",
        "SSB00010001 中 zhong1 国 guo2 人 ren2",
        "SSB00020000|是|shi4 er2 huar1",
        "SSB00020001|x|zzz9 a1",
        "SSB00020007|y|a1"]) + "\n", encoding="utf-8")
    return wavs, label


def test_extract_mel_and_chinese_g2p_match_jax(tmp_path, monkeypatch):
    """The mels bit for bit; the metadata and the phone map byte for byte
    (with and without the GE2E embeddings' root)."""
    wavs, label = _aishell3_tree(tmp_path)
    _run_jax(monkeypatch, "tacotron2_aishell3/extract_mel.py", "--input",
             wavs, "--output", tmp_path / "jax_mel")
    extract_mel.main(["--input", str(wavs), "--output",
                      str(tmp_path / "mel")])
    assert len(_same_trees(tmp_path / "mel", tmp_path / "jax_mel")) == 4
    emb = tmp_path / "emb"
    for spk, i in (("SSB0001", 0), ("SSB0001", 1), ("SSB0002", 0)):
        (emb / spk).mkdir(parents=True, exist_ok=True)
        np.save(emb / spk / f"{spk}{i:04d}.npy", np.zeros(4, np.float32))
    for extra in ([], ["--embed-root", emb]):
        args = ["--transcription", label, "--mel-root", tmp_path / "mel"]
        _run_jax(monkeypatch, "tacotron2_aishell3/chinese_g2p.py", *args,
                 *extra, "--output-dir", tmp_path / "jax_dump")
        chinese_g2p.main([str(a) for a in args + extra + [
            "--output-dir", tmp_path / "dump"]])
        for name in ("metadata.jsonl", "phone_id_map.txt"):
            assert (tmp_path / "dump" / name).read_bytes() == \
                (tmp_path / "jax_dump" / name).read_bytes(), name
        rows = [json.loads(line) for line in
                (tmp_path / "dump" / "metadata.jsonl").read_text().split(
                    "\n") if line]
        assert len(rows) == 3 and (("spk_emb" in rows[0]) == bool(extra))


def test_voice_cloning_dump_chain_embeds_ge2e_mels(tmp_path):
    """The README's order for the AISHELL-3 dump: Tacotron2's mels from
    ``extract_mel.py``, GE2E's own 40-band 16 kHz mels of the same wavs
    from ``ge2e.preprocess``, their embeddings, then ``chinese_g2p.py``
    with them as ``--embed-root``: every row that has a mel gets a unit
    256-wide embedding.  The JAX ``run.sh``'s order (the encoder over the
    80-band mels) fails on the encoder's input width (``lstm_sequence``
    checks it: ``torch.lstm`` on the CPU does not)."""
    from parakeet_tpu_torch.bridge import flax_arrays
    from parakeet_tpu_torch.nn.initializer import init_flax_defaults_
    from parakeet_tpu_torch.training import save_pytree as t_save
    wavs, label = _aishell3_tree(tmp_path)
    extract_mel.main(["--input", str(wavs), "--output",
                      str(tmp_path / "mel")])
    ge2e_preprocess.main(["--input", str(wavs), "--output",
                          str(tmp_path / "ge2e_mels"), "--min-frames", "0",
                          "--num-workers", "1"])
    enc = LSTMSpeakerEncoder(hidden_size=16)
    init_flax_defaults_(enc, torch.Generator().manual_seed(3))
    ckpt = tmp_path / "ge2e.npz"
    t_save(ckpt, flax_arrays(enc))
    args = ["--checkpoint", str(ckpt), "--hidden-size", "16", "--device",
            "cpu"]
    with pytest.raises(ValueError, match="takes 40 channels"):
        ge2e_inference.main(args + ["--input", str(tmp_path / "mel"),
                                    "--output", str(tmp_path / "bad")])
    got = ge2e_inference.main(args + [
        "--input", str(tmp_path / "ge2e_mels"), "--output",
        str(tmp_path / "embed")])
    assert len(got) == 4
    chinese_g2p.main(["--transcription", str(label), "--mel-root",
                      str(tmp_path / "mel"), "--embed-root",
                      str(tmp_path / "embed"), "--output-dir",
                      str(tmp_path / "dump")])
    rows = [json.loads(line) for line in
            (tmp_path / "dump" / "metadata.jsonl").read_text().splitlines()
            if line]
    assert [r["utt_id"] for r in rows] == ["SSB00010000", "SSB00010001",
                                           "SSB00020000"]
    for r in rows:
        emb = np.load(r["spk_emb"])
        assert emb.shape == (256,)
        np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)


def test_aishell3_train_cli_first_loss_matches_jax(tmp_path, monkeypatch):
    """The CLI on the recipe's YAML (stop token off, guided attention on,
    256-wide condition) at tiny widths, every dropout 0: its first batch
    equals the JAX recipe's (its DataTable, BatchSampler and batch_fn)
    and its first step's loss is within 1e-5 of JAX's step from the same
    weights; a second epoch resumes."""
    seen = []
    make = t2_train.make_tacotron2_train_step

    def recording(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def wrapped(state, batch):
            seen.append(({k: a.copy() for k, a in
                          flax_arrays(model).items()},
                         {k: v.numpy().copy() for k, v in batch.items()}))
            state, metrics = step(state, batch)
            seen[-1] += (float(metrics["loss"]),)
            return state, metrics
        return wrapped

    monkeypatch.setattr(t2_train, "make_tacotron2_train_step",
                        recording)
    md = write_synthetic_dump(tmp_path / "dump", seed=4,
                              splits={"train": 4, "dev": 2},
                              frames=(10, 20), phones=(4, 9), n_mels=10)
    argv = ["--config", str(VC_CONF), "--train-metadata", str(md["train"]),
            "--dev-metadata", str(md["dev"]), "--phones-dict",
            str(md["phones"]), "--output-dir", str(tmp_path / "exp"),
            "--device", "cpu", "--opts", *T2_OPTS]
    trainer = vc_train.main(argv + ["max_epoch", "1"])
    weights, batch, loss = seen[0]
    model = trainer.updater.train_state.modules["model"]
    assert model.use_stop_token is False
    assert batch["spk_emb"].shape == (2, 256)

    jrecipe = _jax_recipe("tacotron2_aishell3/train.py")
    table = JDataTable.from_jsonl(md["train"], converters={
        "speech": np.load, "spk_emb": np.load})
    sampler = jloader.BatchSampler(len(table), 2, shuffle=True,
                                   drop_last=True)
    first = jrecipe.batch_fn([table[i] for i in next(iter(sampler))])
    assert first.keys() == batch.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], batch[k], err_msg=k)
    cfg = Config.from_yaml(VC_CONF).merge_opts(T2_OPTS)
    jm = JT2(vocab_size=len(md["phones"].read_text().splitlines()),
             **cfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in first.items()}
    tx = jbuild("adam", cfg.optimizer.learning_rate)
    state = jupd.init_tacotron2_train_state(jm, tx, jax.random.PRNGKey(0),
                                            jbatch)
    shapes = {k: np.shape(a) for k, a in flatten_tree(
        {"params": state.params, "batch_stats": state.batch_stats}).items()}
    assert shapes.keys() == weights.keys()
    variables = nest_flat({k: jnp.asarray(a.reshape(shapes[k]))
                           for k, a in weights.items()})
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    _, metrics = jupd.make_tacotron2_train_step(jm, tx, **cfg.updater)(
        state, jbatch)
    assert "guided_attn_loss" in metrics and "stop_loss" not in metrics
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)

    resumed = vc_train.main(argv + ["max_epoch", "2"])
    assert resumed.updater.state.iteration == 4
    assert all(math.isfinite(float(v))
               for v in resumed.observation.values())


def _tiny_t2_pair(seed, vocab_size):
    """A tiny conditioned Tacotron2 without stop token in JAX and the port,
    the same random weights."""
    kwargs = dict(vocab_size=vocab_size, **T2_TINY, **NO_DROPOUT,
                  d_global_condition=256, use_stop_token=False)
    jm = JT2(**kwargs)
    v = jm.init({"params": jax.random.PRNGKey(1),
                 "dropout": jax.random.PRNGKey(2)},
                jnp.ones((1, 4), jnp.int32), jnp.full((1,), 4),
                jnp.zeros((1, 6, 10)), jnp.full((1,), 6),
                global_condition=jnp.zeros((1, 256)), deterministic=False)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, a in flatten_tree(v).items():
        leaf = key.split("::")[-1]
        if leaf in ("scale", "var"):
            flat[key] = 1.0 + 0.2 * np.abs(rng.standard_normal(a.shape))
        elif leaf in ("bias", "mean"):
            flat[key] = 0.1 * rng.standard_normal(a.shape)
        else:
            flat[key] = rng.standard_normal(a.shape) / np.sqrt(
                max(a[0].size, 1))
        flat[key] = flat[key].astype(np.float32)
    tm = Tacotron2(**kwargs)
    load_flax_params(tm, flat)
    return jm, nest_flat(flat), tm.eval(), flat


@pytest.mark.parametrize("n_tokens", [1, 5])
def test_conditioned_infer_on_padded_text_matches_jax(n_tokens):
    """``ClonedSpeech``'s program (the CLI's ``infer`` at (1, 128), text
    padded with zeros behind ``n_tokens`` ids, the stop token off) against
    JAX's ``infer`` on the same padded text, 24 steps with a grace of 2:
    the lengths equal, the mels and alignments within 1e-5 of their
    range, the alignments zero on the padding.  Both utterances stop
    inside the window, so the frames past the stop are zeroed as JAX
    zeroes them."""
    steps = 24
    jm, v, tm, _ = _tiny_t2_pair(5, 12)
    rng = np.random.default_rng(n_tokens)
    ids = rng.integers(1, 12, n_tokens).tolist()
    spk = rng.standard_normal(256).astype(np.float32)
    spk /= np.linalg.norm(spk)
    text = np.zeros((1, 128), np.int64)
    text[0, :n_tokens] = ids
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(text), jnp.asarray([n_tokens]),
        global_condition=jnp.asarray(spk)[None], max_decoder_steps=steps,
        grace_steps=2, rngs={"dropout": jax.random.PRNGKey(0)},
        method=JT2.infer))(v)
    speech = ClonedSpeech(tm, spk, 128, steps, torch.device("cpu"),
                          graph=False)
    assert "prenet_keep" not in speech.inputs          # no prenet dropout
    speech.load(ids)
    assert torch.equal(speech.inputs["text"], torch.from_numpy(text))
    got = tm.infer(speech.inputs["text"], speech.inputs["text_lengths"],
                   global_condition=speech.inputs["spk_emb"],
                   max_decoder_steps=steps, grace_steps=2)
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    assert 0 < int(got["lengths"][0]) < steps
    _close(got["mel_outputs_postnet"].detach(), want["mel_outputs_postnet"],
           what="mel")
    _close(got["alignments"].detach(), want["alignments"], what="align")
    assert (got["alignments"][0, :, n_tokens:] == 0).all()
    mel, lengths = speech(ids)
    assert mel.shape == (1, steps, 10) and int(lengths[0]) > 0


def _voice_cloning_setup(tmp_path):
    """JAX-written checkpoints (GE2E at its defaults, the tiny conditioned
    Tacotron2, a tiny WaveFlow), their YAMLs, the phone map, two
    sentences and a formant reference wav at 22.05 kHz."""
    ge2e = JEncoder(n_mels=40)
    gv = ge2e.init(jax.random.PRNGKey(0), jnp.zeros((1, 160, 40)))
    save_pytree(tmp_path / "ge2e.npz", {"params": gv["params"]})
    lexicon_phones = ["n", "i3", "h", "au3", "zh", "ung1", "g", "uo2", "r",
                      "en2", "sh", "iii4", "er2", "a1"]
    _, v, _, _ = _tiny_t2_pair(7, len(lexicon_phones))
    save_pytree(tmp_path / "t2.npz", v)
    conf = tmp_path / "conf.yaml"
    model = {**T2_TINY, **NO_DROPOUT, "reduction_factor": 1,
             "use_stop_token": False, "d_global_condition": 256}
    conf.write_text("fs: 16000\nn_mels: 10\nmodel:\n" + "".join(
        f"  {k}: {str(x).lower() if isinstance(x, bool) else x}\n"
        for k, x in model.items()))
    wf_kwargs = dict(upsample_factors=[2, 2], n_flows=2, n_layers=2,
                     n_group=4, channels=8, n_mels=10)
    wf = JWaveFlow(**{**wf_kwargs, "upsample_factors": (2, 2)})
    wv = wf.init(jax.random.PRNGKey(3), jnp.zeros((1, 64)),
                 jnp.zeros((1, 16, 10)))
    save_pytree(tmp_path / "wf.npz", {"params": wv["params"]})
    wf_conf = tmp_path / "wf_conf.yaml"
    wf_conf.write_text("fs: 16000\nmodel:\n" + "".join(
        f"  {k}: {x}\n" for k, x in wf_kwargs.items()))
    (tmp_path / "phones.txt").write_text(
        "".join(f"{p} {i}\n" for i, p in enumerate(lexicon_phones)))
    (tmp_path / "sentences.txt").write_text(
        "utt1 ni3 hao3 zhong1 guo2\nutt2 ren2 shi4 er2 a1 zzz9\n")
    save_wav(tmp_path / "ref.wav",
             formant_utterance(sr=22050, hop_length=220, seed=3)["wav"],
             22050)
    return ["--config", str(conf), "--checkpoint", str(tmp_path / "t2.npz"),
            "--ge2e-checkpoint", str(tmp_path / "ge2e.npz"), "--ref-wav",
            str(tmp_path / "ref.wav"), "--phones-dict",
            str(tmp_path / "phones.txt"), "--text",
            str(tmp_path / "sentences.txt"), "--max-decoder-steps", "16",
            "--device", "cpu"], ["--waveflow-config", str(wf_conf),
                                 "--waveflow-checkpoint",
                                 str(tmp_path / "wf.npz")]


def test_voice_cloning_cli_matches_jax(tmp_path, monkeypatch):
    """``voice_cloning.py --device cpu`` on JAX-written checkpoints: its
    GE2E embedding of the reference (resampled 22.05 -> 16 kHz) within
    1e-5 of the JAX recipe's ``embed_reference``; its mels (no vocoder)
    within 1e-5 of their range of the JAX CLI's, of the same lengths;
    with WaveFlow, a finite 16 kHz wav of frames x 4 samples a line."""
    argv, vocoder = _voice_cloning_setup(tmp_path)
    jrecipe = _jax_recipe("tacotron2_aishell3/voice_cloning.py")
    want = jrecipe.embed_reference(types.SimpleNamespace(
        ge2e_checkpoint=tmp_path / "ge2e.npz", ref_wav=tmp_path / "ref.wav"))
    monkeypatch.setattr(sys, "argv", ["voice_cloning.py"] + argv + [
        "--output-dir", str(tmp_path / "jax_mels")])
    jrecipe.main()
    out = voice_cloning.main(argv + ["--output-dir",
                                     str(tmp_path / "mels")])
    assert out["embedding"].shape == (256,)
    np.testing.assert_allclose(out["embedding"], want, atol=1e-5)
    assert [r["utt_id"] for r in out["lines"]] == ["utt1", "utt2"]
    for r in out["lines"]:
        got = np.load(r["path"])
        ref = np.load(tmp_path / "jax_mels" / f"{r['utt_id']}.npy")
        assert got.shape == ref.shape == (r["frames"], 10)
        _close(got, ref, what=r["utt_id"])
    out = voice_cloning.main(argv + vocoder + [
        "--output-dir", str(tmp_path / "cloned")])
    from parakeet_tpu_torch.audio import load_wav
    for r in out["lines"]:
        wav, sr = load_wav(r["path"])
        assert sr == out["sample_rate"] == 16000
        assert r["samples"] == len(wav) == r["frames"] * 4
        assert np.isfinite(wav).all() and r["vocoder_s"] > 0


def test_ge2e_train_bench_on_cpu(monkeypatch, capsys):
    """The bench's JSON line at tiny widths on the CPU: utterances a
    second, the analytic FLOPs, no MFU off the card, cuDNN's TF32 off (its
    float32 is float32); bf16 refused."""
    from parakeet_tpu_torch.benchmarks import ge2e_train as bench
    from parakeet_tpu_torch.utils.flops import ge2e_train_flops
    monkeypatch.setattr(bench, "MODEL_CONFIG", dict(
        num_layers=2, hidden_size=16, output_size=16))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rec = bench.main(["--iters", "2", "--speakers", "3", "--utts", "2",
                      "--frames", "8", "--n-mels", "8", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert rec["metric"] == "ge2e_train_avg_ips" and rec["value"] > 0
    assert rec["unit"] == "utterances/sec" and rec["backend"] == "cpu"
    assert rec["flops_per_step"] == ge2e_train_flops(
        6, 8, n_mels=8, num_layers=2, hidden_size=16, output_size=16)
    assert rec["mfu_pct"] is None and math.isfinite(rec["loss"])
    assert rec["dtype"] == "float32" and rec["tf32"] is False
    with pytest.raises(NotImplementedError, match="float32"):
        bench.main(["--dtype", "bfloat16", "--device", "cpu"])
