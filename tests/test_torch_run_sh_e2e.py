"""The port's ``run.sh`` pipelines end to end on the CPU (``DEVICE=cpu``)
for the families that tests/test_torch_run_sh.py does not run to wavs:
Tacotron2, TransformerTTS and WaveFlow (their stage 0 shares FastSpeech2's
and PWGAN's host stages, held there against the JAX scripts), and GE2E and
voice cloning, whose host stages are held here against the JAX scripts
(GE2E's stage 0; the cloning pipeline's mel extraction and G2P with its
dev/train split).

Each twin runs under bash from stage 0 to its last, with the same
``Interpreter`` and corpora as tests/test_torch_run_sh.py, at tiny widths
and a few steps: ``CONF`` where the script reads one, else (GE2E's
training flags, the cloning pipeline's YAML, which its script names
itself) through the Interpreter's ``extra`` and ``swap``; the decodes cut
to a few steps and WaveFlow's capacity to the corpus's longest utterance.
Each run must end in its last stage's output: a wav for each dev
mel (WaveFlow), an embedding for each utterance (GE2E), a mel for each
dev utterance or sentence where the script names no vocoder (Tacotron2,
TransformerTTS, voice cloning).
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from parakeet_tpu_torch.recipes import corpus
from test_torch_run_sh import (CORPUS_UTTS, Interpreter, _wavs, jax_script,
                               same_trees, tiny_conf, twin)

T2_TINY = {"model.d_encoder": 16, "model.encoder_conv_layers": 1,
           "model.d_prenet": 8, "model.d_attention_rnn": 12,
           "model.d_decoder_rnn": 12, "model.d_attention": 8,
           "model.attention_filters": 4, "model.d_postnet": 8,
           "model.postnet_conv_layers": 2, "batch_size": 4, "max_epoch": 1}
TT_TINY = {"model.adim": 16, "model.aheads": 2, "model.elayers": 1,
           "model.eunits": 16, "model.dlayers": 1, "model.dunits": 16,
           "model.dprenet_units": 8, "model.postnet_chans": 8,
           "model.postnet_layers": 2, "batch_size": 4, "max_epoch": 1}
WF_TINY = {"model.n_flows": 2, "model.n_layers": 2, "model.n_group": 8,
           "model.channels": 8, "clip_frames": 6, "batch_size": 2,
           "max_iteration": 2, "valid_interval": 2, "save_interval": 2}
GE2E_CUTS = ["--speakers-per-batch", "2", "--utterances-per-speaker", "2",
             "--max-iteration", "2", "--save-interval", "2"]
DECODE_CUTS = ["--max-decoder-steps", "8"]
R = "parakeet_tpu_torch.recipes"


@pytest.fixture(scope="module")
def lj(tmp_path_factory):
    """The 206-utterance corpus of tests/test_torch_run_sh.py (24 kHz;
    the 22.05 kHz YAMLs resample it) and the tiny YAMLs."""
    root = tmp_path_factory.mktemp("lj")
    corpus.write_baker_corpus(root / "corpus", CORPUS_UTTS, seed=0)
    for family, tiny in (("tacotron2", T2_TINY), ("transformer_tts", TT_TINY),
                         ("waveflow", WF_TINY)):
        tiny_conf(family, root / f"{family}.yaml", **tiny)
    return root


@pytest.mark.parametrize("family", ["tacotron2", "transformer_tts"])
def test_ar_twin_end_to_end(lj, tmp_path, family):
    """Stage 0 (FastSpeech2's preprocess and normalize at the tiny YAML's
    22.05 kHz; the YAML names no f0 range), training, then the dev split's
    mels (the script names no vocoder): one for each of its 100 rows."""
    py = Interpreter(tmp_path, extra={f"{R}.{family}.synthesize":
                                      DECODE_CUTS})
    py.check(twin(family), (), {
        "ROOTDIR": lj / "corpus" / "wavs",
        "DURFILE": lj / "corpus" / "durations.txt",
        "CONF": lj / f"{family}.yaml", "DEVICE": "cpu"}, tmp_path)
    assert [c[1] for c in py.calls] == [
        f"{R}.fastspeech2.preprocess", *[f"{R}.fastspeech2.normalize"] * 2,
        f"{R}.{family}.train", f"{R}.{family}.synthesize"]
    rows = (tmp_path / "dump" / "norm" / "dev" /
            "metadata.jsonl").read_text().splitlines()
    assert len(rows) == 100
    _mels(tmp_path / "exp" / "default" / "wavs",
          [json.loads(r)["utt_id"] for r in rows])


def test_waveflow_twin_end_to_end(lj, tmp_path):
    """Stage 0 (PWGAN's preprocess), two iterations, then a wav for each
    mel of MELS (two of the dump's)."""
    py = Interpreter(tmp_path, extra={f"{R}.waveflow.synthesize": [
        "--max-frames", "88"]})
    env = {"ROOTDIR": lj / "corpus" / "wavs", "CONF": lj / "waveflow.yaml",
           "DEVICE": "cpu"}
    py.check(twin("waveflow"), (0, 1), env, tmp_path)
    (tmp_path / "mels").mkdir()
    for utt in ("utt0000", "utt0001"):
        shutil.copy(tmp_path / "dump" / f"{utt}_feats.npy",
                    tmp_path / "mels" / f"{utt}.npy")
    py.check(twin("waveflow"), (2, 2), {**env, "MELS": tmp_path / "mels"},
             tmp_path)
    _wavs(tmp_path / "exp" / "default" / "wavs", 2)


@pytest.fixture(scope="module")
def ge2e_run(tmp_path_factory):
    """Three speakers of two ~2 s utterances at 16 kHz (the preprocess's
    default 160-frame floor), the GE2E twin run from stage 0 to 2 with
    relative paths; returns its directory."""
    root = tmp_path_factory.mktemp("ge2e")
    corpus.write_speaker_tree(root / "speakers", ["spk_a", "spk_b", "spk_c"],
                              2, seed=5, syllables=(8, 9))
    py = Interpreter(root, extra={f"{R}.ge2e.train": GE2E_CUTS})
    py.check(twin("ge2e"), (), {"ROOTDIR": root / "speakers",
                                "DEVICE": "cpu"}, root)
    return root


def test_ge2e_host_stage_matches_jax_and_runs_to_embeddings(ge2e_run,
                                                            tmp_path):
    """Stage 0 of both scripts: the same mel partials; the twin's stage 2
    writes a unit 256-wide embedding for each utterance."""
    py = Interpreter(tmp_path)
    py.check(jax_script("ge2e"), (0, 0), {
        "ROOTDIR": ge2e_run / "speakers", "DUMP": tmp_path / "jax"},
        jax_script("ge2e").parent)
    mels = same_trees(tmp_path / "jax", ge2e_run / "dump" / "ge2e_mels")
    embeds = sorted((ge2e_run / "dump" / "ge2e_embeds").rglob("*.npy"))
    assert len(embeds) == len(mels) == 6
    for path in embeds:
        emb = np.load(path)
        assert emb.shape == (256,)
        np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)


def test_voice_cloning_twin_matches_jax_stages_and_runs_to_mels(
        ge2e_run, tmp_path):
    """106 utterances of two AISHELL-3 speakers at 22.05 kHz and their
    pinyin labels; the twin from stage 0 to 4 with the GE2E twin's
    checkpoint.  The JAX script's stage 0 writes the same mels, and its
    stage 2 on the twin's embeddings the same metadata, phone map and
    100-row dev / 6-row train split; stage 4 writes a mel for each
    sentence."""
    wavs, label = tmp_path / "wav", tmp_path / "label_train-set.txt"
    corpus.write_speaker_tree(wavs, ["SSB0001", "SSB0002"], 53, seed=7,
                              sr=22050, label=label)
    corpus.write_sentences(tmp_path / "sentences.txt",
                           corpus.PINYIN_SENTENCES)
    tiny = tiny_conf("tacotron2_aishell3", tmp_path / "vc.yaml", **T2_TINY)
    ckpt = sorted((ge2e_run / "exp" / "ge2e" / "checkpoints").glob(
        "*.npz"))[-1]
    env = {"WAVROOT": wavs, "LABEL": label, "GE2E_CKPT": ckpt,
           "REF_WAV": wavs / "SSB0001" / "SSB00010000.wav",
           "TEXT": tmp_path / "sentences.txt", "DEVICE": "cpu"}
    swap = {"--config": str(tiny)}
    py = Interpreter(tmp_path, extra={
        f"{R}.tacotron2_aishell3.voice_cloning": DECODE_CUTS},
        swap={f"{R}.tacotron2_aishell3.train": swap,
              f"{R}.tacotron2_aishell3.voice_cloning": swap})
    py.check(twin("tacotron2_aishell3"), (), {**env, "DUMP": tmp_path / "port",
                                              "EXP": tmp_path / "exp"},
             tmp_path)
    jax = tmp_path / "jax"
    py.check(jax_script("tacotron2_aishell3"), (0, 0), {**env, "DUMP": jax},
             jax_script("tacotron2_aishell3").parent)
    shutil.copytree(tmp_path / "port" / "embed", jax / "embed")
    py.check(jax_script("tacotron2_aishell3"), (2, 2), {**env, "DUMP": jax},
             jax_script("tacotron2_aishell3").parent)
    for sub in ("mel", "embed"):
        same_trees(jax / sub, tmp_path / "port" / sub, (jax, tmp_path /
                                                        "port"))
    for name in ("metadata.jsonl", "metadata_dev.jsonl",
                 "metadata_train.jsonl", "phone_id_map.txt"):
        a, b = (jax / name).read_text(), (tmp_path / "port" / name
                                          ).read_text()
        assert a.replace(str(jax), "<root>") == b.replace(
            str(tmp_path / "port"), "<root>"), name
    assert [len((jax / f"metadata_{s}.jsonl").read_text().splitlines())
            for s in ("dev", "train")] == [100, 6]
    _mels(tmp_path / "exp" / "cloned",
          [u for u, _ in corpus.PINYIN_SENTENCES])


def _mels(directory, utts):
    """A finite, non-constant (frames, 80) mel ``<utt>.npy`` under
    ``directory`` for each of ``utts``, and nothing else."""
    mels = sorted(Path(directory).glob("*.npy"))
    assert [p.stem for p in mels] == sorted(utts)
    for path in mels:
        mel = np.load(path)
        assert mel.ndim == 2 and mel.shape[1] == 80 and len(mel) > 0
        assert np.isfinite(mel).all() and mel.std() > 0, path
