"""Guards of the PyTorch port: it imports no JAX and no YAML, and needs no
jieba, its chip smoke test refuses to run without a card, and the smoke
test's model configurations are the recipes' and the flash sweep's, its
text-to-wav phase the recipes' YAMLs and the CLIs' defaults."""
import ast
import importlib.util
import pathlib
import shutil
import subprocess
import sys

import pytest
import yaml

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import parakeet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
print(sorted(m for m in ("jax", "jaxlib", "flax", "optax", "yaml",
                         "parakeet_tpu") if m in sys.modules))
"""


def test_port_imports_no_jax_and_no_yaml():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names, loaded = proc.stdout.split("\n")[:2]
    names = set(names.split())
    assert len(names) >= 15          # every submodule was imported
    assert {"parakeet_tpu_torch.nn.flash", "parakeet_tpu_torch.nn.dropout",
            "parakeet_tpu_torch.ops.kernels.flash_attn",
            "parakeet_tpu_torch.models.fs2_updater",
            "parakeet_tpu_torch.training.config",
            "parakeet_tpu_torch.training.checkpoint",
            "parakeet_tpu_torch.training.extensions.snapshot",
            "parakeet_tpu_torch.data.dataloader",
            "parakeet_tpu_torch.recipes.pwgan.train",
            "parakeet_tpu_torch.benchmarks.train_pwgan",
            "parakeet_tpu_torch.models.transformer_tts",
            "parakeet_tpu_torch.models.waveflow",
            "parakeet_tpu_torch.nn.style_encoder",
            "parakeet_tpu_torch.recipes.transformer_tts.train",
            "parakeet_tpu_torch.recipes.waveflow.train",
            "parakeet_tpu_torch.benchmarks.waveflow_rtf",
            "parakeet_tpu_torch.benchmarks.ar_decode",
            "parakeet_tpu_torch.audio.spectrum",
            "parakeet_tpu_torch.audio.codec",
            "parakeet_tpu_torch.audio.normalizer",
            "parakeet_tpu_torch.audio.features",
            "parakeet_tpu_torch.audio.synthetic",
            "parakeet_tpu_torch.frontend.generate_lexicon",
            "parakeet_tpu_torch.frontend.vocab",
            "parakeet_tpu_torch.utils.mp_tools",
            "parakeet_tpu_torch.models.lstm_speaker_encoder",
            "parakeet_tpu_torch.models.ge2e_updater",
            "parakeet_tpu_torch.recipes.ge2e.preprocess",
            "parakeet_tpu_torch.recipes.ge2e.train",
            "parakeet_tpu_torch.recipes.ge2e.inference",
            "parakeet_tpu_torch.recipes.ge2e.dump",
            "parakeet_tpu_torch.recipes.tacotron2_aishell3.extract_mel",
            "parakeet_tpu_torch.recipes.tacotron2_aishell3.chinese_g2p",
            "parakeet_tpu_torch.recipes.tacotron2_aishell3.train",
            "parakeet_tpu_torch.recipes.tacotron2_aishell3.voice_cloning",
            "parakeet_tpu_torch.recipes.tacotron2_aishell3.dump",
            "parakeet_tpu_torch.benchmarks.ge2e_train",
            "parakeet_tpu_torch.data.preprocess",
            "parakeet_tpu_torch.data.textgrid",
            "parakeet_tpu_torch.frontend.cli",
            "parakeet_tpu_torch.frontend.arpabet",
            "parakeet_tpu_torch.frontend.phonectic",
            "parakeet_tpu_torch.frontend.pinyin",
            "parakeet_tpu_torch.frontend.punctuation",
            "parakeet_tpu_torch.frontend.tone_sandhi",
            "parakeet_tpu_torch.frontend.zh_frontend",
            "parakeet_tpu_torch.frontend._arpabet_data",
            "parakeet_tpu_torch.frontend._pinyin_data",
            "parakeet_tpu_torch.frontend._sandhi_data",
            "parakeet_tpu_torch.frontend.normalizer.normalizer",
            "parakeet_tpu_torch.frontend.normalizer.numbers",
            "parakeet_tpu_torch.frontend.normalizer.abbreviations",
            "parakeet_tpu_torch.frontend.zh_normalization.text_normlization",
            "parakeet_tpu_torch.frontend.zh_normalization.num",
            "parakeet_tpu_torch.frontend.zh_normalization.chronology",
            "parakeet_tpu_torch.frontend.zh_normalization.phonecode",
            "parakeet_tpu_torch.frontend.zh_normalization.quantifier",
            "parakeet_tpu_torch.frontend.zh_normalization.char_convert",
            "parakeet_tpu_torch.frontend.zh_normalization._char_convert_data",
            "parakeet_tpu_torch.recipes.synthesis",
            "parakeet_tpu_torch.recipes.fastspeech2.synthesize_e2e",
            "parakeet_tpu_torch.recipes.fastspeech2.serve",
            "parakeet_tpu_torch.recipes.speedyspeech.synthesize_e2e",
            "parakeet_tpu_torch.recipes.transformer_tts.synthesize_e2e"
            } <= names
    assert loaded == "[]", f"the port pulled in {loaded}"


_WITHOUT_JIEBA = """
import sys
sys.modules["jieba"] = sys.modules["jieba.posseg"] = None   # not installed
from parakeet_tpu_torch.frontend import Frontend, tone_sandhi, zh_frontend
from parakeet_tpu_torch.recipes.fastspeech2 import synthesize_e2e, serve
from parakeet_tpu_torch.recipes.speedyspeech import synthesize_e2e
assert not zh_frontend._HAS_JIEBA and zh_frontend.psg is None
assert not tone_sandhi._HAS_JIEBA and tone_sandhi.jieba is None
print(Frontend(strict=False).get_syllables("今天天气很好"))
"""


def test_port_needs_no_jieba():
    """Where jieba is missing (the card's machine) the frontend and the
    CLIs import, and the Chinese frontend takes its path without
    segmentation."""
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_JIEBA], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    sylls = ast.literal_eval(proc.stdout.strip())
    assert len(sylls) == 6 and all(s[-1] in "12345" for s in sylls)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """On a machine without CUDA (and in a directory holding only the
    script) chip_smoke.py exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_configs_are_the_recipes():
    smoke = _load_chip_smoke()
    fs2 = yaml.safe_load(
        (REPO / "recipes/fastspeech2/conf/default.yaml").read_text())
    pwg = yaml.safe_load(
        (REPO / "recipes/pwgan/conf/default.yaml").read_text())
    skip = ("stack_impl", "init_type")
    assert smoke.FS2_CONFIG == {k: v for k, v in fs2["model"].items()
                                if k not in skip}
    assert smoke.PWG_CONFIG == {k: v for k, v in
                                pwg["generator_params"].items()
                                if k not in skip}
    assert smoke.ODIM == fs2["n_mels"] == pwg["n_mels"]
    assert smoke.SAMPLE_RATE == fs2["fs"] == pwg["fs"]
    # phases 15 and 16: the TransformerTTS and WaveFlow recipes' YAMLs,
    # whose model sections the benches they run build
    from parakeet_tpu_torch.benchmarks import common
    tts = yaml.safe_load((REPO / smoke.TT_RECIPE_CONF).read_text())
    wf = yaml.safe_load((REPO / smoke.WF_RECIPE_CONF).read_text())
    assert smoke.TT_RECIPE_CONF == "recipes/transformer_tts/conf/default.yaml"
    assert smoke.WF_RECIPE_CONF == "recipes/waveflow/conf/default.yaml"
    assert common.TRANSFORMER_TTS_CONFIG == {
        k: v for k, v in tts["model"].items()
        if k not in ("init_type", "reduction_factor")}
    assert common.WAVEFLOW_CONFIG == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in wf["model"].items()}
    assert smoke.ODIM == tts["n_mels"] == wf["n_mels"]
    # two steps an epoch at the YAMLs' batches, one eval batch at least
    for splits, cfg in ((smoke.TT_RECIPE_SPLITS, tts),
                        (smoke.WF_RECIPE_SPLITS, wf)):
        assert splits["train"] == 2 * cfg["batch_size"]
        assert splits["dev"] >= min(cfg["batch_size"], 8)
    # the WaveFlow clips fit in every utterance, and the iteration-based
    # run resumes at an epoch's end, on a snapshot it wrote
    assert smoke.WF_RECIPE_FRAMES[0] > wf["clip_frames"]
    opts = dict(zip(smoke.WF_RECIPE_OPTS[::2], smoke.WF_RECIPE_OPTS[1::2]))
    assert smoke.WF_RECIPE_ITERS == 2 == int(opts["save_interval"])
    assert smoke.WF_RECIPE_RESUME_ITERS % int(opts["valid_interval"]) == 0


def test_chip_smoke_training_slice_is_the_pwgan_recipe():
    smoke = _load_chip_smoke()
    pwg = yaml.safe_load(
        (REPO / "recipes/pwgan/conf/default.yaml").read_text())
    assert smoke.DISC_CONFIG == {k: v for k, v in
                                 pwg["discriminator_params"].items()
                                 if k != "impl"}
    assert (smoke.TRAIN_B, smoke.TRAIN_T) == (pwg["batch_size"],
                                              pwg["batch_max_steps"])
    assert smoke.GEN_LR == pwg["generator_optimizer"]["learning_rate"]
    assert smoke.DISC_LR == pwg["discriminator_optimizer"]["learning_rate"]
    assert pwg["generator_optimizer"]["optim"] == "adam"
    assert pwg["discriminator_optimizer"]["optim"] == "adam"
    assert smoke.LAMBDA_ADV == pwg["updater"]["lambda_adv"]
    assert {k: list(v) for k, v in smoke.STFT_LOSS.items()} == \
        pwg["stft_loss_params"]
    # the recipe trains the stack through the fused kernels ('pallas', the
    # port's 'fused') and lets 'auto' pick the fused discriminator
    assert pwg["generator_params"]["stack_impl"] == "pallas"
    assert pwg["discriminator_params"]["impl"] == "auto"


def test_chip_smoke_fs2_training_slice_is_the_flash_sweep_model():
    """chip_smoke.py's FastSpeech2 training config is the FastSpeech2(...)
    call of benchmarks/flash_sweep.py (without dtype and attn_impl), read
    with ast, at its 1024-frame point: batch = tokens / frames with the
    default --tokens, 64 text tokens, Adam at 1e-4."""
    smoke = _load_chip_smoke()
    tree = ast.parse((REPO / "benchmarks/flash_sweep.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "FastSpeech2"]
    assert len(calls) == 1
    kw = {k.arg: k.value for k in calls[0].keywords}
    assert isinstance(kw.pop("dtype"), ast.Name)
    assert isinstance(kw.pop("attn_impl"), ast.Name)
    # names bound to a literal in the script (odim = 80)
    consts = {t.id: n.value for n in ast.walk(tree)
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and isinstance(n.value,
                                                        ast.Constant)}
    sweep = {k: ast.literal_eval(consts.get(getattr(v, "id", None), v))
             for k, v in kw.items()}
    assert sweep == dict(idim=smoke.IDIM, odim=smoke.ODIM,
                         **smoke.FS2_TRAIN_CONFIG)
    defaults = {a.dest: a.default for a in _sweep_parser(tree)}
    assert smoke.FS2_B * smoke.FS2_FRAMES == defaults["tokens"]
    assert smoke.FS2_FRAMES in defaults["frames"]
    # t = 96 if frames % 96 == 0 else 64 (flash_sweep.py's bench_point)
    assert smoke.FS2_FRAMES % 96 != 0 and smoke.FS2_TOKENS == 64
    opt = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
           and getattr(n.func, "id", None) == "build_optimizer"]
    assert [ast.literal_eval(a) for a in opt[0].args] == ["adam",
                                                         smoke.FS2_LR]


def test_chip_smoke_recipe_phase_resumes_at_an_epoch_boundary():
    """The recipe phase runs the recipe's own YAML with the discriminator
    in 'recompute', and resumes where an epoch ends (the snapshot holds no
    loader state) on a snapshot it wrote, with a dev set of at least one
    batch and clips that every utterance is long enough for."""
    smoke = _load_chip_smoke()
    pwg = yaml.safe_load((REPO / smoke.RECIPE_CONF).read_text())
    opts = dict(zip(smoke.RECIPE_OPTS[::2], smoke.RECIPE_OPTS[1::2]))
    assert opts["discriminator_params.vjp_mode"] == "recompute"
    batch = pwg["batch_size"]
    assert smoke.RECIPE_SPLITS["train"] % batch == 0
    per_epoch = smoke.RECIPE_SPLITS["train"] // batch
    assert smoke.RECIPE_STEPS % per_epoch == 0
    assert smoke.RECIPE_STEPS % smoke.RECIPE_INTERVAL == 0
    assert smoke.RECIPE_RESUME_STEPS % smoke.RECIPE_INTERVAL == 0
    assert smoke.RECIPE_SPLITS["dev"] >= batch
    frames = pwg["batch_max_steps"] // pwg["n_shift"]
    acw = pwg["generator_params"]["aux_context_window"]
    assert smoke.RECIPE_FRAMES[0] > frames + 2 * acw


def test_fs2_sweep_fails_without_a_card():
    proc = subprocess.run([sys.executable, "fs2_sweep.py", "--frames", "64"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr
    assert "frames" not in proc.stdout


def test_fs2_sweep_points_are_the_flash_sweep_points():
    """fs2_sweep.py's --frames and --tokens defaults are flash_sweep.py's."""
    def defaults(path):
        tree = ast.parse((REPO / path).read_text())
        return {a.dest: a.default for a in _sweep_parser(tree)}
    port, jax_side = defaults("fs2_sweep.py"), defaults(
        "benchmarks/flash_sweep.py")
    assert port["frames"] == jax_side["frames"]
    assert port["tokens"] == jax_side["tokens"]


def _sweep_parser(tree):
    """The add_argument calls of flash_sweep.py's parser, as objects with
    ``dest`` and ``default``."""
    class Arg:
        def __init__(self, call):
            self.dest = ast.literal_eval(call.args[0]).lstrip("-")
            self.default = next(ast.literal_eval(k.value)
                                for k in call.keywords if k.arg == "default")
    return [Arg(n) for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"]


def test_chip_smoke_ge2e_and_voice_cloning_phases_are_the_recipes():
    """Phase 17 runs GE2E at the JAX bench's and recipe's defaults (read
    with ast), phase 18 the aishell3 YAML with WaveFlow's recipe, two
    steps an epoch at the YAML's batch and one eval batch at least, and
    sentences of fewer phones than the CLI's 128."""
    smoke = _load_chip_smoke()
    bench = _defaults(REPO / "benchmarks/ge2e_train.py")
    recipe = _defaults(REPO / "recipes/ge2e/train.py")
    assert (smoke.GE2E_SPEAKERS, smoke.GE2E_UTTS, smoke.GE2E_FRAMES,
            smoke.GE2E_MELS) == (bench["speakers"], bench["utts"],
                                 bench["frames"], bench["n-mels"]) == (
        recipe["speakers-per-batch"], recipe["utterances-per-speaker"],
        recipe["frames"], recipe["n-mels"])
    assert smoke.GE2E_LR == recipe["learning-rate"]
    assert smoke.GE2E_TREE_FRAMES[0] >= smoke.GE2E_FRAMES
    assert smoke.VC_RECIPE_CONF == \
        "recipes/tacotron2_aishell3/conf/default.yaml"
    vc = yaml.safe_load((REPO / smoke.VC_RECIPE_CONF).read_text())
    assert vc["model"]["use_stop_token"] is False
    assert vc["updater"]["use_guided_attention_loss"] is True
    assert smoke.VC_RECIPE_SPLITS["train"] == 2 * vc["batch_size"]
    assert smoke.VC_RECIPE_SPLITS["dev"] >= min(vc["batch_size"], 8)
    from parakeet_tpu_torch.frontend import generate_lexicon
    lexicon = generate_lexicon(with_tone=True, with_erhua=True)
    for line in smoke.VC_SENTENCES:
        sylls = line.split()[1:]
        assert all(s in lexicon for s in sylls)
        assert sum(len(lexicon[s].split()) for s in sylls) < 128


def _defaults(path):
    """{flag without dashes: literal default} of a script's add_argument
    calls that have one."""
    out = {}
    for n in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if (isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "add_argument"):
            for k in n.keywords:
                if k.arg == "default":
                    try:
                        out[ast.literal_eval(n.args[0]).lstrip("-")] = \
                            ast.literal_eval(k.value)
                    except ValueError:
                        pass
    return out


@pytest.mark.parametrize("jax_cli,port_cli", [
    ("recipes/fastspeech2/synthesize_e2e.py",
     "parakeet_tpu_torch/recipes/fastspeech2/synthesize_e2e.py"),
    ("recipes/speedyspeech/synthesize_e2e.py",
     "parakeet_tpu_torch/recipes/speedyspeech/synthesize_e2e.py"),
    ("recipes/transformer_tts/synthesize_e2e.py",
     "parakeet_tpu_torch/recipes/transformer_tts/synthesize_e2e.py"),
    ("tools/serve.py", "parakeet_tpu_torch/recipes/fastspeech2/serve.py")])
def test_text_to_wav_clis_keep_the_jax_defaults(jax_cli, port_cli):
    """Each text-to-wav twin parses every flag of its JAX CLI with the
    same literal default (the device's, set by ``add_device_arg``, is the
    card); the refused ``--export-dir`` and ``--sp`` are parsed by
    ``recipes/synthesis.py``."""
    want = _defaults(REPO / jax_cli)
    got = {**_defaults(REPO / "parakeet_tpu_torch/recipes/synthesis.py"),
           **_defaults(REPO / port_cli)}
    assert want and {k: got.get(k) for k in want} == want


def test_chip_smoke_text_to_wav_phase_is_the_recipes():
    """Phase 19 runs the recipes' YAMLs through the CLIs at their
    defaults: four sentences of the Chinese G2P cases, the TransformerTTS
    CLI's 500 decoder steps, a serving batch of 8."""
    smoke = _load_chip_smoke()
    assert (smoke.FS2_RECIPE_CONF, smoke.SS_RECIPE_CONF,
            smoke.TT_RECIPE_CONF, smoke.RECIPE_CONF) == (
        "recipes/fastspeech2/conf/default.yaml",
        "recipes/speedyspeech/conf/default.yaml",
        "recipes/transformer_tts/conf/default.yaml",
        "recipes/pwgan/conf/default.yaml")
    cases = [ln for ln in (REPO / smoke.TTW_CASES).read_text(
        encoding="utf-8").splitlines() if ln and not ln.startswith("#")]
    assert smoke.TTW_LINES == 4 <= len(cases)
    tts = _defaults(REPO / "recipes/transformer_tts/synthesize_e2e.py")
    assert tts["max-decoder-steps"] == 500
    assert smoke.TTW_SERVE_BATCH == 8
    assert smoke.TTW_EN_SENTENCE.split()[0] == "tt_0001"
