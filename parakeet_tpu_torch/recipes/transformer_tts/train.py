"""TransformerTTS training CLI of the port (counterpart of
``recipes/transformer_tts/train.py``; reference:
examples/transformer_tts/train.py).

Reads a recipe YAML (``recipes/transformer_tts/conf/default.yaml`` runs
unchanged: adim 512 over 8 heads, 6 + 6 layers, batch 16) and a
normalised dump in the recipe's format (``metadata.jsonl`` rows with
``text`` ids and the path of a ``.npy`` mel, ``speech``), builds the
model with flax's initializers drawn from the config's seed and then,
for the YAML's ``init_type`` (xavier_uniform), every kernel redrawn from
the seed + 1 (``nn/initializer.py::initialize_``), and trains through
the port's ``Trainer`` on the card with the ``updater`` keys of the YAML
(``loss_type``, ``bce_pos_weight``, the guided attention loss's), the
evaluator on the dev set and ``Snapshot`` every epoch.  A run in a
directory that holds snapshots resumes from the newest and equals a
straight run bit for bit: the training runs under
``deterministic_training`` (PyTorch's deterministic algorithms, cuDNN
off).  The vocabulary is the line count of ``--phones-dict`` (its last
id is the ``<eos>`` the model appends), the mel bands the dump's.

Usage:
  python -m parakeet_tpu_torch.recipes.transformer_tts.train \\
      --config recipes/transformer_tts/conf/default.yaml \\
      --train-metadata dump/train/norm/metadata.jsonl \\
      --dev-metadata dump/dev/norm/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt --output-dir exp/default \\
      [--opts model.reduction_factor 2 ...] [--device cpu]

Not ported: the JAX recipe's ``--dp`` and ``--tp`` (data and tensor
parallelism; ROADMAP queue 1, item 18), ``--profiler-options``, its
TensorBoard writer and alignment figures (item 8), ``synthesize.py`` and
``synthesize_e2e.py`` (item 19).  The YAML's ``rng_impl: rbg`` names a
TPU device generator and is ignored: the port draws every mask from a
``torch.Generator``.
"""
import argparse

import numpy as np
import torch

from ...data import (BatchSampler, DataLoader, DataTable,
                     transformer_tts_batch_fn)
from ...models import (TransformerTTS, init_transformer_tts_,
                       init_transformer_tts_train_state,
                       make_transformer_tts_eval_step,
                       make_transformer_tts_train_step)
from ...nn.initializer import initialize_
from ...training import (Config, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything)
from ...utils.device import set_device
from ..common import add_recipe_args, count_lines, run_trainer

__all__ = ["main", "build_dataloader", "build_model"]


def build_dataloader(metadata, cfg, shuffle: bool) -> DataLoader:
    """Batches of ``cfg.batch_size``, shuffled by epoch with the last
    partial one dropped when ``shuffle`` (train), in order and kept
    otherwise (dev)."""
    table = DataTable.from_jsonl(metadata, converters={"speech": np.load})
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           drop_last=shuffle)
    return DataLoader(table, sampler, transformer_tts_batch_fn)


def build_model(cfg, idim: int, odim: int) -> TransformerTTS:
    """The config's TransformerTTS on the CPU: flax's initializers
    (``init_transformer_tts_``) drawn from the config's seed, then the
    ``init_type`` redraw from the seed + 1, as the JAX recipe does."""
    kwargs = resolve_model_kwargs(cfg.get("model", {}))
    init_type = kwargs.pop("init_type", None)
    model = TransformerTTS(idim=idim, odim=odim, **kwargs)
    seed = cfg.get("seed", 0)
    init_transformer_tts_(model, torch.Generator().manual_seed(seed))
    if init_type:
        initialize_(model, torch.Generator().manual_seed(seed + 1),
                    init_type)
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
    # the mel bands of the dump's first utterance, as the JAX recipe reads
    # them off its first batch
    odim = np.shape(train_dl.dataset[0]["speech"])[-1]
    model = build_model(cfg, count_lines(args.phones_dict), odim).to(device)
    opt_cfg = cfg.get("optimizer", {})
    optimizer = build_optimizer(model.parameters(),
                                opt_cfg.get("optim", "adam"),
                                opt_cfg.get("learning_rate", 1e-3))
    state = init_transformer_tts_train_state(model, optimizer, rng)
    upd = dict(cfg.get("updater", {}))
    return run_trainer(cfg, make_transformer_tts_train_step(model, optimizer,
                                                            **upd),
                       make_transformer_tts_eval_step(model, **upd), state,
                       train_dl, dev_dl, device, args.output_dir)


if __name__ == "__main__":
    main()
