"""Guards of the PyTorch port: it imports no JAX and no YAML, its chip
smoke test refuses to run without a card, and the smoke test's model
configurations are the recipes'."""
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
print(len(names))
print(sorted(m for m in ("jax", "jaxlib", "flax", "optax", "yaml",
                         "parakeet_tpu") if m in sys.modules))
"""


def test_port_imports_no_jax_and_no_yaml():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split("\n")[:2]
    assert int(count) >= 15          # every submodule was imported
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
