"""FastSpeech2 training CLI of the port (counterpart of
``recipes/fastspeech2/train.py``; reference: examples/fastspeech2/
train.py:44-208).

Reads a recipe YAML (every ``recipes/fastspeech2/conf/*.yaml`` runs
unchanged) and a normalised dump in the recipe's format (``metadata.jsonl``
rows whose ``speech``, ``pitch`` and ``energy`` are paths of ``.npy``
arrays), builds the model with flax's default initializers drawn from the
config's seed and, with the model's ``init_type``, redraws its kernels
from seed + 1 as the JAX recipe does; then trains through the port's
``Trainer`` on the card, with the evaluator on the dev set (its last
partial batch kept) and ``Snapshot`` every epoch.  A run in a directory
that holds snapshots resumes from the newest, and equals a straight run
bit for bit: the training runs under PyTorch's deterministic algorithms,
with cuDNN off.  idim is the line count of ``--phones-dict`` (else the
largest id of the first batch + 1), odim the mel width of the dump;
``--speaker-dict`` sets the speaker count and ``spk_embed_dim`` (256
unless the YAML sets it).

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.train \\
      --config recipes/fastspeech2/conf/default.yaml \\
      --train-metadata dump_norm/train/metadata.jsonl \\
      --dev-metadata dump_norm/dev/metadata.jsonl --output-dir exp/default \\
      [--phones-dict dump/phone_id_map.txt] [--speaker-dict ...] \\
      [--opts model.attn_impl flash ...] [--device cpu]

The YAML's ``rng_impl`` (rbg, the TPU's counter-based device generator)
is TPU-only and ignored here.  Not ported: the JAX recipe's
``--dp/--tp/--pp`` (data, tensor and pipeline parallelism; ROADMAP queue
1, item 18), ``--profiler-options`` and its TensorBoard writer (item 8).
"""
import argparse
import functools
from pathlib import Path

import numpy as np
import torch

from ...data import (BatchSampler, DataLoader, DataTable,
                     fastspeech2_batch_fn)
from ...models import (FastSpeech2, init_fs2_train_state, make_fs2_eval_step,
                       make_fs2_train_step)
from ...nn.initializer import init_flax_defaults_, initialize_
from ...training import (Config, Trainer, build_optimizer,
                         resolve_model_kwargs, seed_everything)
from ...utils.device import add_device_arg, set_device
from ..common import count_lines, run_trainer

__all__ = ["main", "build_dataloader", "build_model"]


def build_dataloader(metadata, cfg, shuffle: bool, spk: bool) -> DataLoader:
    """The recipe's loader: the table of ``metadata`` with its arrays
    loaded on access, batches of ``cfg.batch_size`` shuffled by epoch and
    the last partial one dropped when ``shuffle`` (train), in order and
    kept otherwise (dev), collated by ``fastspeech2_batch_fn``."""
    table = DataTable.from_jsonl(
        metadata, converters={"speech": np.load, "pitch": np.load,
                              "energy": np.load})
    sampler = BatchSampler(len(table), cfg.batch_size, shuffle=shuffle,
                           drop_last=shuffle)
    return DataLoader(table, sampler,
                      functools.partial(fastspeech2_batch_fn, spk=spk))


def build_model(cfg, idim: int, odim: int, spk_num=None) -> FastSpeech2:
    """The config's FastSpeech2 on the CPU: flax's default initializers
    from the seed, then ``init_type`` (if set) from seed + 1."""
    kwargs = resolve_model_kwargs(cfg.get("model", {}))
    if spk_num is not None:
        kwargs.setdefault("num_speakers", spk_num)
        kwargs.setdefault("spk_embed_dim", 256)
    init_type = kwargs.pop("init_type", None)
    model = FastSpeech2(idim=idim, odim=odim, **kwargs)
    seed = cfg.get("seed", 0)
    init_flax_defaults_(model, torch.Generator().manual_seed(seed))
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
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--train-metadata", type=Path, required=True)
    parser.add_argument("--dev-metadata", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exp"))
    parser.add_argument("--phones-dict", type=Path, default=None)
    parser.add_argument("--speaker-dict", type=Path, default=None)
    parser.add_argument("--opts", nargs="*", default=[],
                        help="KEY VALUE pairs overriding the config")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    cfg = Config.from_yaml(args.config).merge_opts(args.opts)
    rng = seed_everything(cfg.get("seed", 0), device=device)

    spk = args.speaker_dict is not None
    train_dl = build_dataloader(args.train_metadata, cfg, True, spk)
    dev_dl = build_dataloader(args.dev_metadata, cfg, False, spk)

    sample = next(iter(train_dl))
    odim = sample["speech"].shape[-1]
    idim = (count_lines(args.phones_dict) if args.phones_dict
            else int(max(sample["text"].max() + 1, 2)))
    spk_num = count_lines(args.speaker_dict) if spk else None
    model = build_model(cfg, idim, odim, spk_num).to(device)

    opt_cfg = cfg.get("optimizer", {})
    optimizer = build_optimizer(model.parameters(),
                                opt_cfg.get("optim", "adam"),
                                opt_cfg.get("learning_rate", 1e-3))
    state = init_fs2_train_state(model, optimizer, rng)
    train_step = make_fs2_train_step(model, optimizer,
                                     **cfg.get("updater", {}))
    eval_step = make_fs2_eval_step(model, **cfg.get("updater", {}))

    return run_trainer(cfg, train_step, eval_step, state, train_dl, dev_dl,
                       device, args.output_dir)


if __name__ == "__main__":
    main()
