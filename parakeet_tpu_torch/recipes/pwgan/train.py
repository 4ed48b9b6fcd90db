"""Parallel WaveGAN training CLI of the port (counterpart of
``recipes/pwgan/train.py``; reference: examples/parallelwave_gan/baker/
train.py).

Reads the recipe's YAML (``recipes/pwgan/conf/default.yaml`` runs
unchanged: ``resolve_model_kwargs`` maps the JAX impl names and the
models' ``dtype``) and a dump in
the recipe's format (``metadata_*.jsonl`` rows whose ``wave`` and
``feats`` are paths of ``.npy`` arrays), builds the generator and the
discriminator on the device with weights drawn from the config's seed,
and trains through the port's ``Trainer`` with the GAN updater, the
evaluator on the dev set every ``eval_interval_steps`` and ``Snapshot``
every ``save_interval_steps``.  A run in a directory that holds snapshots
resumes from the newest.

Usage:
  python -m parakeet_tpu_torch.recipes.pwgan.train \\
      --config recipes/pwgan/conf/default.yaml \\
      --train-metadata dump/metadata_train.jsonl \\
      --dev-metadata dump/metadata_dev.jsonl --output-dir exp/default \\
      [--opts discriminator_params.vjp_mode recompute ...] [--device cpu]

Mixed precision (bf16 products, float32 parameters, losses and Adam
state), as the YAML's comment spells it: ``--opts generator_params.dtype
bfloat16 discriminator_params.dtype bfloat16``.

Not ported: the JAX recipe's ``--dp`` (data parallelism) and its
TensorBoard writer (ROADMAP queue 1, items 8 and 18).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...data import BatchSampler, DataLoader, DataTable, VocoderClip
from ...models import (PWGDiscriminator, PWGGenerator, init_pwg_train_state,
                       make_pwg_eval_step, make_pwg_train_step)
from ...models.parallel_wavegan import init_pwg_params_
from ...training import (Config, StandardUpdater, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything,
                         to_device_batch)
from ...training.extensions import Snapshot, StandardEvaluator
from ...utils.device import add_device_arg, set_device

__all__ = ["main", "build_dataloader"]


def build_dataloader(metadata, cfg, shuffle: bool, aux_context_window: int,
                     seed: int) -> DataLoader:
    """The recipe's loader: the table of ``metadata`` with its arrays
    loaded on access, batches of ``cfg.batch_size`` (the last partial one
    dropped) and random clips of ``cfg.batch_max_steps`` samples; shuffle
    order and clips are drawn from ``seed`` and the epoch."""
    table = DataTable.from_jsonl(
        metadata, converters={"wave": np.load, "feats": np.load})
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           seed=seed)
    clip = VocoderClip(batch_max_steps=cfg.batch_max_steps,
                       hop_size=cfg.n_shift,
                       aux_context_window=aux_context_window, seed=seed)
    return DataLoader(table, sampler, clip)


def main(argv=None) -> Trainer:
    """Run the recipe with ``argv`` (default: the command line); returns
    the finished ``Trainer``."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--train-metadata", type=Path, required=True)
    parser.add_argument("--dev-metadata", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exp"))
    parser.add_argument("--opts", nargs="*", default=[],
                        help="KEY VALUE pairs overriding the config")
    parser.add_argument("--profiler-options", default=None,
                        help="'batch_range=[50,60];profile_path=...;"
                             "exit_on_finished=true' torch.profiler window "
                             "(reference --profiler_options)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    cfg = Config.from_yaml(args.config).merge_opts(args.opts)
    seed = cfg.get("seed", 0)
    rng = seed_everything(seed, device=device)

    gen_kwargs = resolve_model_kwargs(cfg.get("generator_params", {}),
                                      compute_dtype=True)
    acw = gen_kwargs.get("aux_context_window", 2)
    train_dl = build_dataloader(args.train_metadata, cfg, True, acw, seed)
    dev_dl = build_dataloader(args.dev_metadata, cfg, False, acw, seed)

    generator = PWGGenerator(**gen_kwargs)
    discriminator = PWGDiscriminator(
        **resolve_model_kwargs(cfg.get("discriminator_params", {}),
                               compute_dtype=True))
    weights = torch.Generator().manual_seed(seed)
    init_pwg_params_(generator, weights)
    init_pwg_params_(discriminator, weights)
    generator.to(device)
    discriminator.to(device)

    g_cfg = cfg.get("generator_optimizer", {})
    d_cfg = cfg.get("discriminator_optimizer", {})
    gen_opt = build_optimizer(generator.parameters(),
                              g_cfg.get("optim", "adam"),
                              g_cfg.get("learning_rate", 1e-4))
    disc_opt = build_optimizer(discriminator.parameters(),
                               d_cfg.get("optim", "adam"),
                               d_cfg.get("learning_rate", 5e-5))
    state = init_pwg_train_state(generator, discriminator, gen_opt, disc_opt,
                                 rng)

    stft_cfg = cfg.get("stft_loss_params", {})
    updater_cfg = cfg.get("updater", {})
    loss_kwargs = dict(
        lambda_adv=updater_cfg.get("lambda_adv", 4.0),
        fft_sizes=tuple(stft_cfg.get("fft_sizes", (1024, 2048, 512))),
        hop_sizes=tuple(stft_cfg.get("hop_sizes", (120, 240, 50))),
        win_lengths=tuple(stft_cfg.get("win_lengths", (600, 1200, 240))))
    train_step = make_pwg_train_step(
        generator, discriminator,
        discriminator_train_start_steps=updater_cfg.get(
            "discriminator_train_start_steps", 100000),
        **loss_kwargs)
    eval_step = make_pwg_eval_step(generator, discriminator, **loss_kwargs)

    def step(st, batch):
        return train_step(st, to_device_batch(batch, device))

    def evaluate(st, batch):
        return eval_step(st, to_device_batch(batch, device))

    updater = StandardUpdater(step, state, train_dl)
    trainer = Trainer(updater, (cfg.train_max_steps, "iteration"),
                      out=args.output_dir, log_interval=100,
                      profiler_options=args.profiler_options, config=cfg)
    trainer.extend(StandardEvaluator(evaluate, dev_dl),
                   trigger=(cfg.get("eval_interval_steps", 1000),
                            "iteration"))
    trainer.extend(Snapshot(max_size=cfg.get("num_snapshots", 5)),
                   trigger=(cfg.get("save_interval_steps", 10000),
                            "iteration"), priority=-100)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
