"""Tacotron2 training CLI of the port (counterpart of
``recipes/tacotron2/train.py``; reference: examples/tacotron2/train.py).

Reads a recipe YAML (``recipes/tacotron2/conf/default.yaml`` runs
unchanged: full widths, batch 32) and a normalised dump in the recipe's
format (``metadata.jsonl`` rows with ``text`` ids and the path of a
``.npy`` mel, ``speech``; rows with the path of a GE2E embedding's
``.npy``, ``spk_emb``, give a global condition, as the AISHELL-3
voice-cloning recipe's do),
builds the model with flax's initializers drawn from the config's seed,
and trains through the port's ``Trainer`` on the card with the
``updater`` keys of the YAML (``use_stop_token_loss``,
``use_guided_attention_loss``, ``sigma``), the evaluator on the dev set
and ``Snapshot`` every epoch.  A run in a directory that holds snapshots
resumes from the newest and equals a straight run bit for bit: the
training runs under ``deterministic_training`` (PyTorch's deterministic
algorithms, cuDNN off: the native LSTM and convolution kernels).  The
vocabulary is the line count of ``--phones-dict``.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2.train \\
      --config recipes/tacotron2/conf/default.yaml \\
      --train-metadata dump/train/norm/metadata.jsonl \\
      --dev-metadata dump/dev/norm/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt --output-dir exp/default \\
      [--opts updater.use_guided_attention_loss true ...] [--device cpu]

Not ported: the JAX recipe's ``--dp`` (data parallelism; ROADMAP queue
1, item 18), ``--profiler-options``, its TensorBoard writer and the
alignment figures (item 8).
"""
import argparse

import numpy as np
import torch

from ...data import (BatchSampler, DataLoader, DataTable,
                     transformer_tts_batch_fn)
from ...models import (Tacotron2, init_tacotron2_,
                       init_tacotron2_train_state, make_tacotron2_eval_step,
                       make_tacotron2_train_step)
from ...training import (Config, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything)
from ...utils.device import set_device
from ..common import add_recipe_args, count_lines, run_trainer

__all__ = ["main", "tacotron2_batch_fn", "build_dataloader", "build_model",
           "CONVERTERS"]

# the rows' mel and, where a row has one, its GE2E embedding are paths of
# .npy files (a converter applies only to the fields a row holds)
CONVERTERS = {"speech": np.load, "spk_emb": np.load}


def tacotron2_batch_fn(examples, text_bucket: int = 16,
                       frame_bucket: int = 64):
    """Tacotron2 training batch (the JAX recipe's own):
    ``transformer_tts_batch_fn`` (text padded to a multiple of
    ``text_bucket``, speech to one of ``frame_bucket``, with zeros, and
    their lengths), with spk_emb stacked when the rows have it."""
    batch = transformer_tts_batch_fn(examples, text_bucket, frame_bucket)
    if "spk_emb" in examples[0]:
        batch["spk_emb"] = np.stack(
            [np.asarray(x["spk_emb"], np.float32) for x in examples])
    return batch


def build_dataloader(metadata, cfg, shuffle: bool) -> DataLoader:
    """Batches of ``cfg.batch_size``, shuffled by epoch with the last
    partial one dropped when ``shuffle`` (train), in order and kept
    otherwise (dev)."""
    table = DataTable.from_jsonl(metadata, converters=CONVERTERS)
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           drop_last=shuffle)
    return DataLoader(table, sampler, tacotron2_batch_fn)


def build_model(cfg, vocab_size: int) -> Tacotron2:
    """The config's Tacotron2 on the CPU, with flax's initializers
    (``init_tacotron2_``) drawn from the config's seed."""
    model = Tacotron2(vocab_size=vocab_size,
                      **resolve_model_kwargs(cfg.get("model", {})))
    init_tacotron2_(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    return model


def main(argv=None) -> Trainer:
    """Run the recipe with ``argv`` (default: the command line); returns
    the finished ``Trainer``."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_recipe_args(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    cfg = Config.from_yaml(args.config).merge_opts(args.opts)
    rng = seed_everything(cfg.get("seed", 0), device=device)
    train_dl = build_dataloader(args.train_metadata, cfg, True)
    dev_dl = build_dataloader(args.dev_metadata, cfg, False)
    model = build_model(cfg, count_lines(args.phones_dict)).to(device)
    opt_cfg = cfg.get("optimizer", {})
    optimizer = build_optimizer(model.parameters(),
                                opt_cfg.get("optim", "adam"),
                                opt_cfg.get("learning_rate", 1e-3))
    state = init_tacotron2_train_state(model, optimizer, rng)
    upd = dict(cfg.get("updater", {}))
    return run_trainer(cfg, make_tacotron2_train_step(model, optimizer,
                                                      **upd),
                       make_tacotron2_eval_step(model, **upd), state,
                       train_dl, dev_dl, device, args.output_dir)


if __name__ == "__main__":
    main()
