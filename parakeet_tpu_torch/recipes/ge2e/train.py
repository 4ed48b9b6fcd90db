"""GE2E speaker-encoder training CLI of the port (counterpart of
``recipes/ge2e/train.py``; reference: examples/ge2e/train.py).

Expects per-speaker directories of mel .npy utterances,
``<data-root>/<speaker>/*.npy`` each (T, n_mels) (``preprocess.py``'s
output, or ``dump.py``'s seeded tree).  Each batch is N speakers x M
utterances, random crops of ``--frames``, drawn by ``MultiSpeakerSampler``
from a ``random.Random(seed)`` stream copied from the JAX recipe, which
draws the same batches (the JAX recipe's first batch initialises its
model; this one draws and drops it).  The encoder takes flax's
initializers from the seed, trains with Adam and no clip on the card, and
a snapshot of the train state in the JAX package's format (the bridge's
``train_state_arrays``) goes into a ring of 5 every ``--save-interval``
iterations.  The loop is the JAX recipe's plain one: no evaluation and no
resume.

Usage:
  python -m parakeet_tpu_torch.recipes.ge2e.train --data-root dump/mels \\
      --output-dir exp/ge2e [--speakers-per-batch 64] \\
      [--utterances-per-speaker 10] [--frames 160] [--device cpu]
"""
import argparse
import random
from pathlib import Path

import numpy as np
import torch

from ...bridge import train_state_arrays
from ...models import (LSTMSpeakerEncoder, init_ge2e_train_state,
                       make_ge2e_train_step)
from ...nn.initializer import init_flax_defaults_
from ...training import (SnapshotRing, build_optimizer, save_pytree,
                         seed_everything)
from ...utils.device import add_device_arg, set_device

__all__ = ["main", "MultiSpeakerSampler"]

LOG_INTERVAL = 100


class MultiSpeakerSampler:
    """N speakers x M utterances per batch (reference:
    examples/ge2e/speaker_verification_dataset.py:70), the JAX recipe's
    sampler copied: the same seed draws the same batches."""

    def __init__(self, root: Path, n_speakers: int, n_utts: int,
                 frames: int, seed: int = 0):
        self.speakers = [d for d in sorted(Path(root).iterdir())
                         if d.is_dir()]
        if len(self.speakers) < n_speakers:
            raise ValueError(
                f"need >= {n_speakers} speakers, found {len(self.speakers)}")
        self.files = {d: sorted(d.glob("*.npy")) for d in self.speakers}
        self.n_speakers = n_speakers
        self.n_utts = n_utts
        self.frames = frames
        self.rng = random.Random(seed)

    def _crop(self, mel: np.ndarray) -> np.ndarray:
        if mel.shape[0] <= self.frames:
            mel = np.pad(mel, ((0, self.frames - mel.shape[0] + 1), (0, 0)))
        start = self.rng.randrange(0, mel.shape[0] - self.frames)
        return mel[start:start + self.frames]

    def batch(self) -> np.ndarray:
        """(N*M, frames, n_mels) float32, each speaker's M together."""
        spk = self.rng.sample(self.speakers, self.n_speakers)
        utts = []
        for s in spk:
            files = self.files[s]
            chosen = (self.rng.sample(files, self.n_utts)
                      if len(files) >= self.n_utts
                      else [self.rng.choice(files)
                            for _ in range(self.n_utts)])
            utts.extend(self._crop(np.load(f)) for f in chosen)
        return np.stack(utts).astype(np.float32)


def main(argv=None):
    """Train with ``argv`` (default: the command line); returns the train
    state and the last iteration's metrics."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data-root", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("exp"))
    parser.add_argument("--speakers-per-batch", type=int, default=64)
    parser.add_argument("--utterances-per-speaker", type=int, default=10)
    parser.add_argument("--frames", type=int, default=160)
    parser.add_argument("--n-mels", type=int, default=40)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--max-iteration", type=int, default=1560000)
    parser.add_argument("--save-interval", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=0)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    seed_everything(args.seed, device=device)
    sampler = MultiSpeakerSampler(args.data_root, args.speakers_per_batch,
                                  args.utterances_per_speaker, args.frames,
                                  args.seed)
    sampler.batch()                 # the JAX recipe's initialising batch
    model = LSTMSpeakerEncoder(n_mels=args.n_mels)
    init_flax_defaults_(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    optimizer = build_optimizer(model.parameters(), "adam",
                                args.learning_rate)
    state = init_ge2e_train_state(model, optimizer)
    step = make_ge2e_train_step(model, optimizer, args.speakers_per_batch)

    ring = SnapshotRing(args.output_dir / "checkpoints", max_size=5)
    metrics = {}
    for it in range(1, args.max_iteration + 1):
        batch = {"utterances": torch.from_numpy(sampler.batch()).to(device)}
        state, metrics = step(state, batch)
        if it % LOG_INTERVAL == 0:
            print(f"iter {it}: loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.3f}")
        if it % args.save_interval == 0:
            path = ring.path_for(it)
            save_pytree(path, train_state_arrays(state),
                        metadata={"iteration": it})
            ring.register(path, it)
    return state, metrics


if __name__ == "__main__":
    main()
