"""The port's ``run.sh`` pipelines (``parakeet_tpu_torch/recipes/*/run.sh``)
against the JAX package's (``recipes/*/run.sh``), on the CPU.

- Statically, each of the eight: ``bash -n``, the same stage numbers and
  the same ``${VAR:-...}``/``${VAR:?...}`` variables as the JAX script,
  plus ``DEVICE``; every stage a ``python -m parakeet_tpu_torch...`` call.
- The host stages, both scripts run by bash on one seeded formant corpus
  (``parakeet_tpu_torch/recipes/corpus.py``): FastSpeech2's stages 0-1
  (which Tacotron2's and TransformerTTS's stage 0 run), SpeedySpeech's,
  PWGAN's with and without ``DURFILE`` (WaveFlow's stage 0 runs the
  first), GE2E's stage 0, and the voice-cloning pipeline's mel and G2P
  stages.  The two dump trees hold the same relative files, each ``.npy``
  bit for bit (as tests/test_torch_prepare.py holds the CLIs) and every
  other file the same text once each tree's root is swapped for a
  placeholder.

Both scripts run under bash as written; the ``python`` on their PATH is
``Interpreter``'s, which hands each command line to this test process to
run in place (the JAX scripts through ``runpy``, the port's modules
through their ``main``): a process a stage would spend most of its time
importing torch, scipy and JAX.  It runs ``--num-cpu 8`` with one process
(the same dump: tests/test_torch_prepare.py::
test_preprocess_in_worker_processes_is_the_same).  tests/
test_torch_run_sh_e2e.py runs each twin from stage 0 to its last.

The corpora hold more than the 200 dev and test utterances that the
scripts' preprocess keeps by default (``recipes/common.py::
add_split_args``; the scripts pass no split sizes), and a few to train on.
"""
import importlib
import importlib.util
import json
import os
import re
import runpy
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from parakeet_tpu_torch.recipes import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["fastspeech2", "speedyspeech", "tacotron2", "transformer_tts",
            "pwgan", "waveflow", "ge2e", "tacotron2_aishell3"]
# 200 dev and test utterances and six to train on
CORPUS_UTTS = 206
VC_UTTS = (2, 53)                 # AISHELL-3: 100 dev rows (head -100), 6
GE2E_SPEAKERS = (3, 2)            # GE2E: 3 speakers x 2 utterances


def twin(family):
    return ROOT / "parakeet_tpu_torch" / "recipes" / family / "run.sh"


def jax_script(family):
    return ROOT / "recipes" / family / "run.sh"


class Interpreter:
    """A ``python`` for a bash script's PATH that runs each command line in
    this process: the program connects to a Unix socket, sends its working
    directory and arguments, and exits with the status that ``check``
    answers.  ``python -m MODULE ...`` calls ``MODULE.main()`` and
    ``python SCRIPT ...`` runs the script as ``__main__``, each with
    ``sys.argv`` set and in the command's directory; ``extra`` appends
    arguments to a module's command line and ``swap`` replaces the values
    of some of its flags ({module: {flag: value}}).  ``calls`` records
    every command line as the script gave it, ``errors`` the tracebacks of
    those that raised."""

    def __init__(self, tmp, extra=None, swap=None):
        self.bin = Path(tmp) / "bin"
        self.bin.mkdir(parents=True, exist_ok=True)
        self.path = Path(tmp) / "python.sock"
        self.extra, self.swap = extra or {}, swap or {}
        self.calls, self.errors = [], []
        program = self.bin / "python"
        program.write_text(
            f"#!{sys.executable} -S\n"
            "import json, os, socket, sys\n"
            "s = socket.socket(socket.AF_UNIX)\n"
            f"s.connect({str(self.path)!r})\n"
            "s.sendall(json.dumps([os.getcwd(), sys.argv[1:]]).encode()"
            " + b'\\n')\n"
            "sys.exit(int(s.makefile().readline()))\n")
        program.chmod(0o755)

    def check(self, script, stages=(), env=None, cwd=None):
        """``bash script *stages`` in ``cwd`` with ``env`` added to this
        process's environment, which must exit 0."""
        env = {**os.environ, **{k: str(v) for k, v in (env or {}).items()},
               "PATH": f"{self.bin}:{os.environ['PATH']}"}
        if self.path.exists():
            self.path.unlink()
        with socket.socket(socket.AF_UNIX) as server:
            server.bind(str(self.path))
            server.listen()
            server.settimeout(0.05)
            proc = subprocess.Popen(["bash", str(script),
                                     *map(str, stages)], cwd=cwd, env=env)
            while proc.poll() is None:
                try:
                    conn, _ = server.accept()
                except socket.timeout:
                    continue
                with conn:
                    cwd_, argv = json.loads(conn.makefile().readline())
                    conn.sendall(f"{self._call(cwd_, argv)}\n".encode())
        rc = proc.wait()
        assert rc == 0, f"{script} {stages}: exit {rc}\n" + "\n".join(
            self.errors)

    def _call(self, cwd, argv):
        self.calls.append(argv)
        swap = {"--num-cpu": "1", **self.swap.get(
            argv[1] if argv[0] == "-m" else None, {})}
        argv = [swap.get(prev, a) for prev, a in zip([None, *argv], argv)]
        saved = os.getcwd(), sys.argv
        os.chdir(cwd)
        try:
            if argv[0] == "-m":
                module = argv[1]
                sys.argv = [module, *argv[2:], *self.extra.get(module, [])]
                importlib.import_module(module).main()
            else:
                sys.argv = [str(Path(cwd, argv[0])), *argv[1:]]
                runpy.run_path(sys.argv[0], run_name="__main__")
            return 0
        except SystemExit as e:
            if e.code in (None, 0):
                return 0
            self.errors.append(f"{argv}: exit {e.code}")
            return 1
        except BaseException:
            self.errors.append(f"{argv}:\n{traceback.format_exc()}")
            return 1
        finally:
            os.chdir(saved[0])
            sys.argv = saved[1]


def same_trees(a, b, roots=None):
    """The trees under ``a`` and ``b``: the same relative files, each .npy
    bit for bit and every other file the same text once each side's root
    (``roots``, default ``a`` and ``b``) is swapped for a placeholder.
    Returns the relative paths."""
    a, b = Path(a), Path(b)
    roots = roots or (a, b)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*")
                                     if p.is_file())
    for rel in files:
        x, y = a / rel, b / rel
        if rel.suffix == ".npy":
            u, v = np.load(x), np.load(y)
            assert u.dtype == v.dtype and np.array_equal(u, v), rel
        else:
            assert (x.read_text().replace(str(roots[0]), "<root>")
                    == y.read_text().replace(str(roots[1]), "<root>")), rel
    return files


def stage_numbers(text):
    return sorted({int(n) for n in re.findall(
        r'\[ "\$stage" -le (\d+) \] && \[ "\$stop_stage" -ge \1 \]', text)})


def variables(text):
    return sorted(set(re.findall(r"\$\{([A-Z_]+):[-?]", text)))


@pytest.mark.parametrize("family", FAMILIES)
def test_twin_keeps_the_jax_stages_and_variables(family):
    """``bash -n``; the JAX script's stages and variables, plus DEVICE;
    ``set -euo pipefail``; each stage's commands are ``python -m
    parakeet_tpu_torch.recipes...`` (the JAX stage's CLI of the same
    name), ``ls``, ``head``, ``tail`` and ``mkdir``; ``--device`` on
    every command whose CLI takes one."""
    path = twin(family)
    assert subprocess.run(["bash", "-n", str(path)]).returncode == 0
    assert os.access(path, os.X_OK)
    ours, theirs = path.read_text(), jax_script(family).read_text()
    assert "set -euo pipefail" in ours and "sys.path" not in ours
    assert stage_numbers(ours) == stage_numbers(theirs)
    assert variables(ours) == sorted(variables(theirs) + ["DEVICE"])
    # the CLIs, stage by stage, by their file names
    assert _clis(ours) == _clis(theirs, family)
    for module, command in _commands(ours, family):
        spec = importlib.util.find_spec(module)
        assert spec is not None, module
        takes_device = re.search(r"add_device_arg|--device", Path(
            spec.origin).read_text()) is not None
        assert ('--device "$device"' in command) == takes_device, command


def _commands(text, family):
    """(module, command line with its continuations) of each ``python
    -m`` in a twin, the module's shell variable expanded."""
    names = {"$cli": f"parakeet_tpu_torch.recipes.{family}",
             "$fs2": "parakeet_tpu_torch.recipes.fastspeech2",
             "$ge2e": "parakeet_tpu_torch.recipes.ge2e"}
    out = []
    for m in re.finditer(r"python -m (\S+)((?:[^\n]*\\\n)*[^\n]*)", text):
        module = m.group(1)
        for var, pkg in names.items():
            module = module.replace(var, pkg)
        out.append((module, m.group(0)))
    assert out
    return out


def _clis(text, family=None):
    """Each stage's CLI names in order ("preprocess", ...): the JAX
    script's ``python [../<dir>/]<name>.py``, the twin's ``python -m
    ...<name>``.  The voice-cloning twin's stage 1 adds GE2E's
    preprocess before the embedding."""
    blocks = re.split(r'\nif \[ "\$stage" -le', text)[1:]
    out = []
    for block in blocks:
        names = re.findall(r"python (?:-m \S+\.|(?:\.\./\w+/)?)(\w+)", block)
        out.append(names)
    if family == "tacotron2_aishell3":
        out[1] = ["preprocess", *out[1]]
    return out


def tiny_conf(family, out, **overrides):
    """The recipe's YAML with ``overrides`` ({"a.b": value}) written to
    ``out``; returns ``out``."""
    cfg = yaml.safe_load((ROOT / "recipes" / family / "conf" /
                          "default.yaml").read_text())
    for key, value in overrides.items():
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    out = Path(out)
    out.write_text(yaml.safe_dump(cfg, default_flow_style=None,
                                  sort_keys=False))
    return out


# the runs' cuts: tiny widths and a few steps; the audio keys stay the
# YAMLs' (the host stages write the dumps of the default YAMLs)
PWG_TINY = {"generator_params.layers": 4, "generator_params.stacks": 2,
            "generator_params.residual_channels": 8,
            "generator_params.gate_channels": 16,
            "generator_params.skip_channels": 8,
            "generator_params.stack_impl": "auto",
            "discriminator_params.layers": 3,
            "discriminator_params.conv_channels": 8,
            "batch_size": 2, "batch_max_steps": 2400,
            "updater.discriminator_train_start_steps": 1,
            "train_max_steps": 2, "eval_interval_steps": 2,
            "save_interval_steps": 2}
FS2_TINY = {"model.adim": 16, "model.aheads": 2, "model.elayers": 1,
            "model.eunits": 32, "model.dlayers": 1, "model.dunits": 32,
            "model.postnet_layers": 2, "model.postnet_chans": 8,
            "model.duration_predictor_chans": 8,
            "model.pitch_predictor_chans": 8,
            "model.energy_predictor_chans": 8, "batch_size": 2,
            "max_epoch": 1}
SS_TINY = {"model.encoder_hidden_size": 16,
           "model.duration_predictor_hidden_size": 16,
           "model.decoder_hidden_size": 16, "model.encoder_dilations": [1, 3],
           "model.decoder_dilations": [1, 3, 9], "batch_size": 4,
           "max_epoch": 1}


# the synthesis stages' static capacity cut to the corpus's longest
# utterance (68 frames)
SYNTH_CUTS = {"parakeet_tpu_torch.recipes.pwgan.synthesize": [
    "--max-frames", "72"]}


@pytest.fixture(scope="module")
def baker(tmp_path_factory):
    """206 formant utterances at 24 kHz with their durations (numpy seed
    0), the sentences, the tiny YAMLs, and an Interpreter."""
    root = tmp_path_factory.mktemp("baker")
    corpus.write_baker_corpus(root / "corpus", CORPUS_UTTS, seed=0)
    corpus.write_sentences(root / "sentences.txt", corpus.SENTENCES)
    for family, tiny in (("pwgan", PWG_TINY), ("fastspeech2", FS2_TINY),
                         ("speedyspeech", SS_TINY)):
        tiny_conf(family, root / f"{family}.yaml", **tiny)
    return root


def _env(root, **kw):
    return {"ROOTDIR": root / "corpus" / "wavs",
            "TEXT": root / "sentences.txt", "DEVICE": "cpu", **kw}


@pytest.fixture(scope="module")
def pwgan_run(baker):
    """The PWGAN twin, stages 0-3 at the tiny YAML without DURFILE, from
    a directory of its own (relative DUMP and EXP); returns its
    directory."""
    cwd = baker / "pwgan"
    cwd.mkdir()
    py = Interpreter(cwd, extra=SYNTH_CUTS)
    py.check(twin("pwgan"), (0, 1), _env(baker), cwd)
    py.check(twin("pwgan"), (2, 3), _env(baker, CONF=baker / "pwgan.yaml"),
             cwd)
    return cwd


@pytest.mark.parametrize("durfile", [False, True])
def test_pwgan_host_stages_match_jax(baker, pwgan_run, tmp_path, durfile):
    """Stages 0-1 of both scripts at the default YAML, with ``--cut-sil``
    when DURFILE is set and without: the same dump (raw, stats, train
    and dev normalized)."""
    env = _env(baker)
    if durfile:
        env["DURFILE"] = baker / "corpus" / "durations.txt"
    py = Interpreter(tmp_path)
    py.check(jax_script("pwgan"), (0, 1), {**env, "DUMP": tmp_path / "jax"},
             jax_script("pwgan").parent)
    if durfile:
        py.check(twin("pwgan"), (0, 1), {**env, "DUMP": tmp_path / "port"},
                 tmp_path)
        port = tmp_path / "port"
    else:
        port = pwgan_run / "dump"
    files = same_trees(tmp_path / "jax", port, (
        tmp_path / "jax", tmp_path / "port" if durfile else "dump"))
    assert len([f for f in files if f.parts[0] == "raw"]) > 2 * CORPUS_UTTS


def _wavs(directory, n):
    """The ``n`` wavs under ``directory``: finite, not silent."""
    from parakeet_tpu_torch.audio.codec import load_wav
    paths = sorted(Path(directory).glob("*.wav"))
    assert len(paths) == n
    for p in paths:
        wav, _ = load_wav(p)
        assert wav.size > 0 and np.isfinite(wav).all()
        assert np.abs(wav).max() > 0, p
    return paths


def test_pwgan_twin_end_to_end(pwgan_run):
    """Stages 0-3 under DEVICE=cpu: a wav for each dev utterance."""
    rows = (pwgan_run / "dump" / "dev" / "norm" /
            "metadata.jsonl").read_text().splitlines()
    assert len(rows) == 100
    _wavs(pwgan_run / "exp" / "default" / "wavs", len(rows))


def _pwg_ckpt(pwgan_run):
    return sorted((pwgan_run / "exp" / "default" / "checkpoints").glob(
        "*.npz"))[-1]


@pytest.mark.parametrize("family", ["fastspeech2", "speedyspeech"])
def test_am_twin_host_stages_match_jax_and_run_to_wavs(baker, pwgan_run,
                                                       tmp_path, family):
    """Stages 0-1 of both scripts at the default YAML: the same dump;
    then the twin's later stages at the tiny YAML with the PWGAN twin's
    checkpoint: a wav for each sentence (SpeedySpeech: also through its
    exported programs, stage 4)."""
    env = _env(baker, DURFILE=baker / "corpus" / "durations.txt")
    py = Interpreter(tmp_path)
    py.check(jax_script(family), (0, 1), {**env, "DUMP": tmp_path / "jax"},
             jax_script(family).parent)
    py.check(twin(family), (0, 1), {**env, "DUMP": tmp_path / "port"},
             tmp_path)
    files = same_trees(tmp_path / "jax", tmp_path / "port")
    assert "phone_id_map.txt" in {str(f) for f in files}
    py.check(twin(family), (2, 100), {
        **env, "DUMP": tmp_path / "port", "EXP": tmp_path / "exp",
        "CONF": baker / f"{family}.yaml", "PWG_CONF": baker / "pwgan.yaml",
        "PWG_CKPT": _pwg_ckpt(pwgan_run)}, tmp_path)
    n = len(corpus.SENTENCES)
    _wavs(tmp_path / "exp" / "wavs", n)
    if family == "speedyspeech":
        _wavs(tmp_path / "exp" / "wavs_deployed", n)
