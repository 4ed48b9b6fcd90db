"""WaveFlow training CLI of the port (counterpart of
``recipes/waveflow/train.py``; reference: examples/waveflow/train.py).

Reads a recipe YAML (``recipes/waveflow/conf/default.yaml`` runs
unchanged: 8 flows x 8 layers, n_group 16, 128 channels, upsampling
16 x 16; batch 8 of 65-frame clips) and a dump in the PWGAN recipe's
format (``metadata_*.jsonl`` rows whose ``wave`` and ``feats`` are paths
of ``.npy`` arrays), builds the model with flax's initializers drawn from
the config's seed (each flow's output projection zero: a fresh model is
the identity) and trains through the port's ``Trainer`` on the card for
``max_iteration`` steps, with the evaluator on the dev set every
``valid_interval`` steps and ``Snapshot`` every ``save_interval``.  Each
batch holds random aligned (wav, mel) clips (``WaveFlowClip``).  A run
in a directory that holds snapshots resumes from the newest and, when the
snapshot falls at the end of an epoch (it holds no loader state), equals
a straight run bit for bit: the training runs under
``deterministic_training`` (PyTorch's deterministic algorithms, cuDNN
off).

Usage:
  python -m parakeet_tpu_torch.recipes.waveflow.train \\
      --config recipes/waveflow/conf/default.yaml \\
      --train-metadata dump/metadata_train.jsonl \\
      --dev-metadata dump/metadata_dev.jsonl --output-dir exp/default \\
      [--opts max_iteration 1000 ...] [--device cpu]

Not ported: the JAX recipe's ``--dp`` (data parallelism; ROADMAP queue
1, item 18), ``--profiler-options``, its TensorBoard writer (item 8) and
``synthesize.py`` (item 19).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...data import BatchSampler, DataLoader, DataTable
from ...models import (ConditionalWaveFlow, init_waveflow_,
                       init_waveflow_train_state, make_waveflow_eval_step,
                       make_waveflow_train_step)
from ...training import (Config, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything)
from ...utils.device import add_device_arg, set_device
from ..common import run_trainer

__all__ = ["main", "WaveFlowClip", "build_dataloader", "build_model"]


class WaveFlowClip:
    """A random aligned (wav, mel) clip of ``clip_frames`` mel frames from
    each example (the JAX recipe's; reference: examples/waveflow/
    ljspeech.py LJSpeechClipCollector): an utterance no longer than the
    clip is zero-padded to one frame more, the start frame is uniform
    over the rest, and the wav clip is ``clip_frames * hop`` samples
    (zero-padded when short).  Returns {"wav": (B, clip_frames * hop),
    "mel": (B, clip_frames, n_mels)}.

    The start frames of epoch 0 come from ``np.random.default_rng(seed)``,
    as the JAX recipe's; ``set_epoch`` (the ``DataLoader`` calls it at the
    start of every pass) reseeds a later epoch from (seed, epoch), where
    the JAX recipe's one stream goes on, so that a run resumed at an epoch
    boundary draws the clips an uninterrupted run draws.
    """

    def __init__(self, clip_frames: int, hop: int, seed: int = 0):
        self.clip_frames, self.hop, self.seed = clip_frames, hop, seed
        self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        self.rng = np.random.default_rng(
            self.seed if epoch == 0 else (self.seed, epoch))

    def __call__(self, examples):
        wavs, mels = [], []
        for ex in examples:
            wav = np.asarray(ex["wave"], np.float32)
            mel = np.asarray(ex["feats"], np.float32)
            frames = mel.shape[0]
            if frames <= self.clip_frames:
                pad = self.clip_frames - frames + 1
                mel = np.pad(mel, ((0, pad), (0, 0)))
                wav = np.pad(wav, (0, pad * self.hop))
                frames = mel.shape[0]
            start = int(self.rng.integers(0, frames - self.clip_frames))
            mels.append(mel[start:start + self.clip_frames])
            s = start * self.hop
            need = self.clip_frames * self.hop
            clip = wav[s:s + need]
            if len(clip) < need:
                clip = np.pad(clip, (0, need - len(clip)))
            wavs.append(clip)
        return {"wav": np.stack(wavs), "mel": np.stack(mels)}


def build_dataloader(metadata, cfg, shuffle: bool, seed: int = 0
                     ) -> DataLoader:
    """Batches of ``cfg.batch_size`` (the last partial one dropped),
    shuffled by epoch when ``shuffle``, of ``WaveFlowClip`` clips drawn
    from ``seed``."""
    table = DataTable.from_jsonl(
        metadata, converters={"wave": np.load, "feats": np.load})
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           drop_last=True)
    return DataLoader(table, sampler,
                      WaveFlowClip(cfg.clip_frames, cfg.n_shift, seed))


def build_model(cfg) -> ConditionalWaveFlow:
    """The config's ConditionalWaveFlow on the CPU with flax's
    initializers (``init_waveflow_``) drawn from the config's seed."""
    model = ConditionalWaveFlow(**resolve_model_kwargs(cfg.get("model", {})))
    init_waveflow_(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    return model


def main(argv=None) -> Trainer:
    """Run the recipe with ``argv`` (default: the command line); returns
    the finished ``Trainer``."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--train-metadata", type=Path, required=True)
    parser.add_argument("--dev-metadata", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exp"))
    parser.add_argument("--opts", nargs="*", default=[],
                        help="KEY VALUE pairs overriding the config")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    cfg = Config.from_yaml(args.config).merge_opts(args.opts)
    seed = cfg.get("seed", 0)
    rng = seed_everything(seed, device=device)
    train_dl = build_dataloader(args.train_metadata, cfg, True, seed)
    dev_dl = build_dataloader(args.dev_metadata, cfg, False)
    model = build_model(cfg).to(device)
    opt_cfg = cfg.get("optimizer", {})
    optimizer = build_optimizer(model.parameters(),
                                opt_cfg.get("optim", "adam"),
                                opt_cfg.get("learning_rate", 2e-4))
    state = init_waveflow_train_state(model, optimizer, rng)
    sigma = model.sigma
    return run_trainer(
        cfg, make_waveflow_train_step(model, optimizer, sigma=sigma),
        make_waveflow_eval_step(model, sigma=sigma), state, train_dl,
        dev_dl, device, args.output_dir,
        stop=(cfg.max_iteration, "iteration"),
        eval_trigger=(cfg.get("valid_interval", 1000), "iteration"),
        save_trigger=(cfg.get("save_interval", 10000), "iteration"),
        log_interval=100)


if __name__ == "__main__":
    main()
