"""The SpeedySpeech, Tacotron2, TransformerTTS and WaveFlow recipes and
the per-family benches of the PyTorch port, on the CPU at tiny widths:
each recipe CLI trains 1 epoch, resumes to 2 and must equal a straight
2-epoch run bitwise (through the snapshot: parameters, Adam moments,
BatchNorm statistics, the LSTM cells' stacked gates and the generator);
each bench's ``main`` prints finite records; the analytic FLOP counts
hold against a hand count and the JAX package's."""
import json
import math

import numpy as np
import pytest
import torch

from parakeet_tpu.utils import flops as jflops
from parakeet_tpu_torch.benchmarks import (ar_decode, e2e_family_rtf,
                                           train_am, waveflow_rtf)
from parakeet_tpu_torch.models.parallel_wavegan import edge_pad
from parakeet_tpu_torch.recipes.speedyspeech import train as ss_train
from parakeet_tpu_torch.recipes.speedyspeech.dump import \
    write_synthetic_dump as ss_dump
from parakeet_tpu_torch.recipes.tacotron2 import train as t2_train
from parakeet_tpu_torch.recipes.tacotron2.dump import \
    write_synthetic_dump as t2_dump
from parakeet_tpu_torch.recipes.transformer_tts import train as tt_train
from parakeet_tpu_torch.recipes.transformer_tts.dump import \
    write_synthetic_dump as tt_dump
from parakeet_tpu_torch.recipes.waveflow import train as wf_train
from parakeet_tpu_torch.recipes.waveflow.dump import \
    write_synthetic_dump as wf_dump
from parakeet_tpu_torch.utils.flops import waveflow_sampler_flops

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
TT_SMALL = dict(adim=16, aheads=2, elayers=1, eunits=16, dlayers=1,
                dunits=16, dprenet_units=8, postnet_chans=8,
                postnet_layers=2, embed_dim=0, eprenet_conv_layers=0)
TT_OPTS = [x for k, v in TT_SMALL.items() for x in (f"model.{k}", str(v))
           ] + ["batch_size", "4"]
WF_SMALL = dict(upsample_factors=(4, 4), n_flows=2, n_layers=2, n_group=8,
                channels=8, n_mels=8, kernel_size=(3, 3), sigma=1.0)
WF_OPTS = ["model.upsample_factors", "[4, 4]", "model.n_flows", "2",
           "model.n_layers", "2", "model.n_group", "8", "model.channels",
           "8", "model.n_mels", "8", "n_shift", "16", "clip_frames", "6",
           "batch_size", "2", "valid_interval", "2", "save_interval", "2"]


def _run(train, argv, out, epochs, opts):
    trainer = train.main(argv + ["--output-dir", str(out), "--device", "cpu",
                                 "--opts", *opts, "max_epoch", str(epochs)])
    return ({k: float(v) for k, v in trainer.observation.items()},
            trainer.updater.state.iteration)


def _run_iterations(argv, out, iterations):
    trainer = wf_train.main(argv + ["--output-dir", str(out), "--device",
                                    "cpu", "--opts", *WF_OPTS,
                                    "max_iteration", str(iterations)])
    return ({k: float(v) for k, v in trainer.observation.items()},
            trainer.updater.state.iteration)


@pytest.mark.parametrize("family", ["speedyspeech", "tacotron2",
                                    "transformer_tts", "waveflow"])
def test_recipe_resumes_bitwise(tmp_path, family):
    """1 epoch (2 steps of 4; WaveFlow: 2 iterations of 2 clips), a second
    run to 2 epochs (4 iterations) that resumes from the snapshot, and a
    straight run: the last train and eval metrics equal bitwise, all
    finite."""
    if family == "waveflow":
        md = wf_dump(tmp_path / "dump", seed=3, splits={"train": 4,
                                                        "dev": 2},
                     frames=(5, 12), n_mels=8, n_shift=16)
        argv = ["--config", "recipes/waveflow/conf/default.yaml",
                "--train-metadata", str(md["train"]), "--dev-metadata",
                str(md["dev"])]
        first, it = _run_iterations(argv, tmp_path / "resumed", 2)
        assert it == 2 and "eval/loss" in first
        resumed, it = _run_iterations(argv, tmp_path / "resumed", 4)
        assert it == 4
        straight, it = _run_iterations(argv, tmp_path / "straight", 4)
    else:
        if family == "speedyspeech":
            md = ss_dump(tmp_path / "dump", seed=3,
                         splits={"train": 8, "dev": 3}, frames=(30, 60),
                         phones=(6, 12), n_mels=8)
            argv = ["--config", "recipes/speedyspeech/conf/default.yaml",
                    "--tones-dict", str(md["tones"])]
            train, opts = ss_train, SS_OPTS + ["model.decoder_output_size",
                                               "8"]
        else:
            dump = t2_dump if family == "tacotron2" else tt_dump
            md = dump(tmp_path / "dump", seed=3,
                      splits={"train": 8, "dev": 3}, frames=(10, 20),
                      phones=(4, 9), n_mels=8)
            argv = ["--config", f"recipes/{family}/conf/default.yaml"]
            train, opts = ((t2_train, T2_OPTS + ["model.d_mels", "8"])
                           if family == "tacotron2" else (tt_train, TT_OPTS))
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


@pytest.mark.parametrize("train", [ss_train, t2_train, tt_train, wf_train])
def test_recipe_help_names_what_is_not_ported(train, capsys):
    """``--help`` lists the JAX recipe's flags and says that ``--dp``
    waits for ROADMAP queue 1, item 18 (TransformerTTS: ``--tp`` too, and
    that ``rng_impl: rbg`` is ignored)."""
    with pytest.raises(SystemExit) as done:
        train.main(["--help"])
    assert done.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    for flag in ("--config", "--train-metadata", "--dev-metadata",
                 "--output-dir", "--opts", "--device"):
        assert flag in text
    assert ("--phones-dict" in text) == (train is not wf_train)
    assert "--dp" in text and "item 18" in text
    assert ("--tones-dict" in text) == (train is ss_train)
    if train is tt_train:
        assert "--tp" in text and "rng_impl: rbg" in text
        assert "ignored" in text


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(e2e_family_rtf, "MODEL_CONFIGS", {
        "tacotron2": T2_SMALL, "speedyspeech": SS_SMALL,
        "transformer_tts": TT_SMALL})
    monkeypatch.setattr(e2e_family_rtf, "PWG_CONFIG", dict(
        layers=4, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_context_window=2))
    monkeypatch.setattr(e2e_family_rtf, "TEXT_LEN", 8)
    monkeypatch.setattr(e2e_family_rtf, "FRAMES", 12)
    monkeypatch.setattr(train_am, "MODEL_CONFIGS", {
        "tacotron2": T2_SMALL, "speedyspeech": SS_SMALL,
        "transformer_tts": TT_SMALL, "waveflow": WF_SMALL})
    monkeypatch.setattr(train_am, "WAVEFLOW_FRAMES", 6)
    monkeypatch.setattr(waveflow_rtf, "MODEL_CONFIG", WF_SMALL)
    monkeypatch.setattr(ar_decode, "MODEL_CONFIGS", {
        "tacotron2": T2_SMALL, "transformer_tts": TT_SMALL})
    monkeypatch.setattr(ar_decode, "TEXT_LEN", 8)


def test_family_rtf_bench_on_cpu(tiny, capsys):
    """Every leg on the CPU (eager): one JSON line each, a finite RTF,
    the family's samples (12 frames x 256 or x 300; TransformerTTS at r=2
    in 6 decoder steps), no kernel launch (the CPU runs K1's plain
    version) and no graph."""
    records = e2e_family_rtf.main(["--device", "cpu", "--iters", "1",
                                   "--dtype", "float32"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == records
    assert [r["metric"] for r in records] == [
        "tacotron2_pwgan_e2e_rtf", "transformer_tts_r1_pwgan_e2e_rtf",
        "transformer_tts_r2_pwgan_e2e_rtf", "speedyspeech_pwgan_e2e_rtf"]
    for r, hop in zip(records, (256, 256, 256, 300)):
        assert r["value"] > 0 and r["samples"] == 12 * hop
        assert r["launches"] == {"K1": 0} and r["graph_ms"] is None
        assert r["capture_s"] is None
        assert 0 <= r["frame_lengths"][0] <= 12
    # ``--frames`` sets the capacity (TransformerTTS at r=2 in 4 steps)
    (short,) = e2e_family_rtf.main(["--device", "cpu", "--iters", "1",
                                    "--dtype", "float32", "--families",
                                    "transformer_tts_r2", "--frames", "8"])
    assert short["samples"] == 8 * 256
    with pytest.raises(ValueError, match="unknown family"):
        e2e_family_rtf.main(["--device", "cpu", "--families",
                             "transformer_tts_r3"])


@pytest.mark.parametrize("family", ["transformer_tts_r1",
                                    "transformer_tts_r2"])
def test_transformer_tts_program_is_the_models_composed(tiny, family):
    """A TransformerTTS program's wav is the vocoder on the edge-padded
    mel of ``inference`` over 12 / r steps with the program's decoder
    prenet masks, which drop."""
    prog = e2e_family_rtf.FamilyProgram(family, torch.float32,
                                        torch.device("cpu"))
    r = int(family[-1])
    keep = prog.inputs["prenet_keep"]
    assert keep.shape == (2, 12 // r, 1, 1, TT_SMALL["dprenet_units"])
    assert 0.3 < keep.float().mean() < 0.7
    wav, lengths = prog.eager()
    with torch.no_grad():
        out = prog.am.inference(prog.inputs["text"],
                                prog.inputs["text_lengths"],
                                max_decoder_steps=12 // r, prenet_keep=keep)
        want = prog.pwg(prog.inputs["noise"], edge_pad(out["mel"], 2))[
            ..., 0]
    assert torch.equal(wav, want) and torch.equal(lengths, out["lengths"])


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
    """Every leg on the CPU at 2 x 8 tokens x 24 frames (WaveFlow: 8
    clips of 6 frames), with and without the deterministic setting (given
    back after), and in bf16 (flax's mixed precision)."""
    for det in ([], ["--deterministic"]):
        records = train_am.main(["--device", "cpu", "--iters", "1",
                                 "--batch-size", "2", "--text-len", "8",
                                 "--frames", "24", *det])
        assert [r["metric"] for r in records] == [
            "tacotron2_train_avg_ips", "transformer_tts_train_avg_ips",
            "speedyspeech_train_avg_ips", "waveflow_train_avg_ips"]
        assert all(r["value"] > 0 and r["deterministic"] == bool(det)
                   for r in records)
        assert (records[-1]["batch_size"], records[-1]["frames"]) == (8, 6)
        assert not torch.are_deterministic_algorithms_enabled()
    assert len(capsys.readouterr().out.splitlines()) == 8
    with pytest.raises(ValueError, match="unknown family"):
        train_am.main(["--device", "cpu", "--models", "ge2e"])
    bf16 = train_am.main(["--device", "cpu", "--iters", "1",
                          "--batch-size", "2", "--text-len", "8",
                          "--frames", "24", "--dtype", "bfloat16"])
    assert all(r["dtype"] == "bfloat16" and r["value"] > 0 for r in bf16)
    assert len(capsys.readouterr().out.splitlines()) == 4
    assert np.isfinite(records[0]["ms_per_step"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_waveflow_rtf_bench_on_cpu(tiny, capsys, dtype):
    """The sampler bench on the CPU (eager) at 5 frames: one JSON line, a
    finite RTF, the analytic FLOPs of its shape, no graph and no MFU (the
    CPU has no stated peak); bf16 sampling within 0.05 of float32 on the
    same weights and noise."""
    rec = waveflow_rtf.main(["--device", "cpu", "--iters", "1", "--frames",
                             "5", "--dtype", dtype])
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["value"] > 0 and rec["samples"] == 5 * 16
    assert rec["flops"] == waveflow_sampler_flops(
        80, n_flows=2, n_layers=2, n_group=8, channels=8, mel_bands=8)
    assert rec["graph_ms"] is None and rec["mfu_pct"] is None
    _, x32 = waveflow_rtf.run("float32", torch.device("cpu"), 1, 5)
    _, x = waveflow_rtf.run(dtype, torch.device("cpu"), 1, 5)
    assert (x - x32).abs().max().item() <= 0.05


def test_ar_decode_bench_on_cpu(tiny, capsys):
    """Both models on the CPU (eager) over 6 steps, TransformerTTS at r=2
    and r=1: finite ms a step, the analytic step FLOPs (twice the step
    modules' weights plus the attention terms)."""
    records = ar_decode.main(["--device", "cpu", "--steps", "6", "--iters",
                              "1", "--reduction-factor", "2"])
    records += ar_decode.main(["--device", "cpu", "--steps", "6", "--iters",
                               "1", "--models", "transformer_tts"])
    assert len(capsys.readouterr().out.splitlines()) == 3
    assert [r["metric"] for r in records] == [
        "tacotron2_decode_ms_per_step", "transformer_tts_decode_ms_per_step",
        "transformer_tts_decode_ms_per_step"]
    assert [r["reduction_factor"] for r in records] == [1, 2, 1]
    assert all(r["value"] > 0 and r["graph_ms"] is None for r in records)
    prog = ar_decode.DecodeProgram("transformer_tts", torch.float32,
                                   torch.device("cpu"), 6)
    am = prog.am
    weights = sum(p.numel() for m in (am.decoder, am.decoder_prenet,
                                      am.decoder_prenet_proj, am.feat_out,
                                      am.prob_out) for p in m.parameters())
    assert records[2]["step_flops"] == prog.step_flops() == (
        2.0 * weights + 1 * 4.0 * 16 * (6 + 8))


def test_waveflow_sampler_flops_by_hand_and_against_jax():
    """The recipe's sampler at 344 frames (88,064 samples, W 5,504): per
    row and layer three (W, 384) x (384, 256) tap products, the (W, 80) x
    (80, 256) conditioning and the (W, 128) x (128, 256) output product,
    per row the (W, 128) x (128, 2) skips; 15 rows x 8 flows; 2 FLOPs a
    multiply-add: 3.68 TFLOP, as the JAX package counts."""
    w = 88064 // 16
    per_row = 8 * (3 * w * 384 * 256 + w * 80 * 256 + w * 128 * 256) \
        + w * 128 * 2
    want = 2.0 * per_row * 15 * 8
    assert waveflow_sampler_flops(88064) == want
    assert 3.67e12 < want < 3.69e12
    for kw in ({}, dict(n_flows=2, n_layers=3, n_group=32, channels=8,
                        mel_bands=6, kernel_size=(3, 5))):
        assert waveflow_sampler_flops(4096, **kw) == \
            jflops.waveflow_sampler_flops(4096, **kw)
