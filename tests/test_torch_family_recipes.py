"""The SpeedySpeech and Tacotron2 recipes and per-family benches of the
PyTorch port, on the CPU at tiny widths: each recipe CLI trains 1 epoch,
resumes to 2 and must equal a straight 2-epoch run bitwise (through the
snapshot: parameters, Adam moments, BatchNorm statistics, the LSTM
cells' stacked gates and the generator); each bench's ``main`` prints
finite records; the legs of the families not ported yet raise."""
import json
import math

import numpy as np
import pytest
import torch

from parakeet_tpu_torch.benchmarks import e2e_family_rtf, train_am
from parakeet_tpu_torch.models.parallel_wavegan import edge_pad
from parakeet_tpu_torch.recipes.speedyspeech import train as ss_train
from parakeet_tpu_torch.recipes.speedyspeech.dump import \
    write_synthetic_dump as ss_dump
from parakeet_tpu_torch.recipes.tacotron2 import train as t2_train
from parakeet_tpu_torch.recipes.tacotron2.dump import \
    write_synthetic_dump as t2_dump

torch.set_num_threads(1)

SS_OPTS = ["model.encoder_hidden_size", "16",
           "model.duration_predictor_hidden_size", "16",
           "model.decoder_hidden_size", "16",
           "model.encoder_dilations", "[1, 3]",
           "model.decoder_dilations", "[1, 3, 9]", "batch_size", "4"]
T2_OPTS = ["model.d_encoder", "16", "model.encoder_conv_layers", "1",
           "model.d_prenet", "8", "model.d_attention_rnn", "12",
           "model.d_decoder_rnn", "12", "model.d_attention", "8",
           "model.attention_filters", "4", "model.d_postnet", "8",
           "model.postnet_conv_layers", "2", "batch_size", "4"]
T2_SMALL = dict(d_encoder=16, encoder_conv_layers=1, d_prenet=8,
                d_attention_rnn=12, d_decoder_rnn=12, d_attention=8,
                attention_filters=4, d_postnet=8, postnet_conv_layers=2)
SS_SMALL = dict(encoder_hidden_size=16, duration_predictor_hidden_size=16,
                decoder_hidden_size=16, encoder_dilations=(1, 3),
                decoder_dilations=(1, 3, 9))


def _run(train, argv, out, epochs, opts):
    trainer = train.main(argv + ["--output-dir", str(out), "--device", "cpu",
                                 "--opts", *opts, "max_epoch", str(epochs)])
    return ({k: float(v) for k, v in trainer.observation.items()},
            trainer.updater.state.iteration)


@pytest.mark.parametrize("family", ["speedyspeech", "tacotron2"])
def test_recipe_resumes_bitwise(tmp_path, family):
    """1 epoch (2 steps of 4), a second run to 2 epochs that resumes from
    the snapshot, and a straight 2-epoch run: the last train and eval
    metrics equal bitwise, all finite."""
    if family == "speedyspeech":
        md = ss_dump(tmp_path / "dump", seed=3, splits={"train": 8, "dev": 3},
                     frames=(30, 60), phones=(6, 12), n_mels=8)
        argv = ["--config", "recipes/speedyspeech/conf/default.yaml",
                "--tones-dict", str(md["tones"])]
        train, opts = ss_train, SS_OPTS + ["model.decoder_output_size", "8"]
    else:
        md = t2_dump(tmp_path / "dump", seed=3, splits={"train": 8, "dev": 3},
                     frames=(10, 20), phones=(4, 9), n_mels=8)
        argv = ["--config", "recipes/tacotron2/conf/default.yaml"]
        train, opts = t2_train, T2_OPTS + ["model.d_mels", "8"]
    argv += ["--train-metadata", str(md["train"]), "--dev-metadata",
             str(md["dev"]), "--phones-dict", str(md["phones"])]
    first, it = _run(train, argv, tmp_path / "resumed", 1, opts)
    assert it == 2 and "eval/loss" in first
    resumed, it = _run(train, argv, tmp_path / "resumed", 2, opts)
    assert it == 4
    straight, it = _run(train, argv, tmp_path / "straight", 2, opts)
    assert it == 4
    assert resumed == straight
    assert all(math.isfinite(v) for v in straight.values())
    assert resumed["train/loss"] != first["train/loss"]


@pytest.mark.parametrize("train", [ss_train, t2_train])
def test_recipe_help_names_what_is_not_ported(train, capsys):
    """``--help`` lists the JAX recipe's flags and says that ``--dp``
    waits for ROADMAP queue 1, item 18."""
    with pytest.raises(SystemExit) as done:
        train.main(["--help"])
    assert done.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    for flag in ("--config", "--train-metadata", "--dev-metadata",
                 "--phones-dict", "--output-dir", "--opts", "--device"):
        assert flag in text
    assert "--dp" in text and "item 18" in text
    assert ("--tones-dict" in text) == (train is ss_train)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(e2e_family_rtf, "MODEL_CONFIGS", {
        "tacotron2": T2_SMALL, "speedyspeech": SS_SMALL})
    monkeypatch.setattr(e2e_family_rtf, "PWG_CONFIG", dict(
        layers=4, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_context_window=2))
    monkeypatch.setattr(e2e_family_rtf, "TEXT_LEN", 8)
    monkeypatch.setattr(e2e_family_rtf, "FRAMES", 12)
    monkeypatch.setattr(train_am, "MODEL_CONFIGS", {
        "tacotron2": T2_SMALL, "speedyspeech": SS_SMALL})


def test_family_rtf_bench_on_cpu(tiny, capsys):
    """Both legs on the CPU (eager): one JSON line each, a finite RTF,
    the family's samples (12 frames x 256 or x 300) and no kernel launch
    (the CPU runs K1's plain version)."""
    records = e2e_family_rtf.main(["--device", "cpu", "--iters", "1",
                                   "--dtype", "float32"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == records
    assert [r["metric"] for r in records] == [
        "tacotron2_pwgan_e2e_rtf", "speedyspeech_pwgan_e2e_rtf"]
    for r, hop in zip(records, (256, 300)):
        assert r["value"] > 0 and r["samples"] == 12 * hop
        assert r["launches"] == {"K1": 0} and r["graph_ms"] is None
        assert 0 <= r["frame_lengths"][0]
    with pytest.raises(NotImplementedError, match="item 13"):
        e2e_family_rtf.main(["--device", "cpu", "--families",
                             "transformer_tts_r1"])


def test_family_program_is_the_models_composed(tiny):
    """The Tacotron2 program's wav is the vocoder on the edge-padded mel
    of ``infer`` with the program's prenet masks, and the masks drop."""
    prog = e2e_family_rtf.FamilyProgram("tacotron2", torch.float32,
                                        torch.device("cpu"))
    keep = prog.inputs["prenet_keep"]
    assert keep.shape == (2, 12, 1, T2_SMALL["d_prenet"])
    assert 0.3 < keep.float().mean() < 0.7
    wav, _ = prog.eager()
    with torch.no_grad():
        mel = prog.am.infer(prog.inputs["text"], prog.inputs["text_lengths"],
                            max_decoder_steps=12, prenet_keep=keep)
        want = prog.pwg(prog.inputs["noise"], edge_pad(
            mel["mel_outputs_postnet"], 2))[..., 0]
    assert torch.equal(wav, want)


def test_train_am_bench_on_cpu(tiny, capsys):
    """Both legs on the CPU at 2 x 8 tokens x 24 frames, with and without
    the deterministic setting (given back after); the unported legs and
    bf16 raise."""
    for det in ([], ["--deterministic"]):
        records = train_am.main(["--device", "cpu", "--iters", "1",
                                 "--batch-size", "2", "--text-len", "8",
                                 "--frames", "24", *det])
        assert [r["metric"] for r in records] == [
            "tacotron2_train_avg_ips", "speedyspeech_train_avg_ips"]
        assert all(r["value"] > 0 and r["deterministic"] == bool(det)
                   for r in records)
        assert not torch.are_deterministic_algorithms_enabled()
    assert len(capsys.readouterr().out.splitlines()) == 4
    for name, item in (("transformer_tts", 13), ("waveflow", 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            train_am.main(["--device", "cpu", "--models", name])
    with pytest.raises(NotImplementedError, match="item 10"):
        train_am.main(["--device", "cpu", "--dtype", "bfloat16"])
    assert np.isfinite(records[0]["ms_per_step"])
