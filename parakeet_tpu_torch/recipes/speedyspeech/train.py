"""SpeedySpeech training CLI of the port (counterpart of
``recipes/speedyspeech/train.py``; reference: examples/speedyspeech/baker/
train.py).

Reads a recipe YAML (``recipes/speedyspeech/conf/default.yaml`` runs
unchanged) and a normalised dump in the recipe's format
(``metadata.jsonl`` rows with ``phones``, ``tones``, ``durations`` and the
path of a ``.npy`` mel, ``feats``), builds the model with flax's default
initializers drawn from the config's seed, and trains through the port's
``Trainer`` on the card, with the evaluator on the dev set (its last
partial batch kept) and ``Snapshot`` every epoch.  A run in a directory
that holds snapshots resumes from the newest and equals a straight run
bit for bit: the training runs under ``deterministic_training`` (PyTorch's
deterministic algorithms, cuDNN off).  The vocabulary is the line count
of ``--phones-dict``, the tone count that of ``--tones-dict``.

Usage:
  python -m parakeet_tpu_torch.recipes.speedyspeech.train \\
      --config recipes/speedyspeech/conf/default.yaml \\
      --train-metadata dump/train/norm/metadata.jsonl \\
      --dev-metadata dump/dev/norm/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt \\
      --tones-dict dump/tone_id_map.txt --output-dir exp/default \\
      [--opts batch_size 16 ...] [--device cpu]

Not ported: the JAX recipe's ``--dp`` (data parallelism; ROADMAP queue
1, item 18), ``--profiler-options`` and its TensorBoard writer (item 8).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...data import (BatchSampler, DataLoader, DataTable,
                     speedyspeech_batch_fn)
from ...models import (SpeedySpeech, init_speedyspeech_train_state,
                       make_speedyspeech_eval_step,
                       make_speedyspeech_train_step)
from ...nn.initializer import init_flax_defaults_
from ...training import (Config, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything)
from ...utils.device import set_device
from ..common import add_recipe_args, count_lines, run_trainer

__all__ = ["main", "build_dataloader", "build_model"]


def build_dataloader(metadata, cfg, shuffle: bool) -> DataLoader:
    """The recipe's loader: batches of ``cfg.batch_size``, shuffled by
    epoch with the last partial one dropped when ``shuffle`` (train), in
    order and kept otherwise (dev), collated by ``speedyspeech_batch_fn``."""
    table = DataTable.from_jsonl(metadata, converters={"feats": np.load})
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           drop_last=shuffle)
    return DataLoader(table, sampler, speedyspeech_batch_fn)


def build_model(cfg, vocab_size: int, tone_size=None) -> SpeedySpeech:
    """The config's SpeedySpeech on the CPU, flax's default initializers
    drawn from the config's seed."""
    model = SpeedySpeech(vocab_size=vocab_size, tone_size=tone_size,
                         **resolve_model_kwargs(cfg.get("model", {})))
    init_flax_defaults_(model, torch.Generator().manual_seed(
        cfg.get("seed", 0)))
    return model


def main(argv=None) -> Trainer:
    """Run the recipe with ``argv`` (default: the command line); returns
    the finished ``Trainer``."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_recipe_args(parser)
    parser.add_argument("--tones-dict", type=Path, default=None)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    cfg = Config.from_yaml(args.config).merge_opts(args.opts)
    rng = seed_everything(cfg.get("seed", 0), device=device)
    train_dl = build_dataloader(args.train_metadata, cfg, True)
    dev_dl = build_dataloader(args.dev_metadata, cfg, False)
    tone_size = count_lines(args.tones_dict) if args.tones_dict else None
    model = build_model(cfg, count_lines(args.phones_dict),
                        tone_size).to(device)
    opt_cfg = cfg.get("optimizer", {})
    optimizer = build_optimizer(model.parameters(),
                                opt_cfg.get("optim", "adam"),
                                opt_cfg.get("learning_rate", 2e-3))
    state = init_speedyspeech_train_state(model, optimizer, rng)
    return run_trainer(cfg, make_speedyspeech_train_step(model, optimizer),
                       make_speedyspeech_eval_step(model), state, train_dl,
                       dev_dl, device, args.output_dir)


if __name__ == "__main__":
    main()
