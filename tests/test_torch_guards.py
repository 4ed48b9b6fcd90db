"""Guards of the PyTorch port: it imports no JAX and no YAML, its chip
smoke test refuses to run without a card, and the smoke test's model
configurations are the recipes' and the flash sweep's."""
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
            "parakeet_tpu_torch.benchmarks.train_pwgan"} <= names
    assert loaded == "[]", f"the port pulled in {loaded}"


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
