"""Whether GE2E's exporter should pad each utterance's partial windows to
a multiple of 8 on the card.

The JAX exporter (``recipes/ge2e/inference.py``) pads the partials of
every utterance to a multiple of 8 rows so that one XLA compile serves
every length, and drops the padded rows' embeddings.  The port's exporter
(``parakeet_tpu_torch/recipes/ge2e/inference.py``) embeds the partials as
they are.  This times both policies through ``embed_utterance`` on the
card, at the encoder's default widths (3 x 256 LSTM over 40 mels, a
256-wide embedding, float32 with TF32 off, flax's initializers from
``--seed``), on ``--utterances`` standard normal mels of 160-300 frames
drawn from the same seed, in turns (as they are, padded, padded, as they
are), each turn one warm-up pass and one timed pass over every utterance
(CUDA events, the mels already in host memory), and prints the ms an
utterance of each turn and the largest difference between the two
policies' embeddings.  The card's name and power limit come first, as
``nvidia-smi`` gives them.

Usage (on the card, from the repository's root):
    python3 tools/ge2e_partial_buckets.py [--utterances 64] [--seed 0]
"""
import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from parakeet_tpu_torch.models import (LSTMSpeakerEncoder,  # noqa: E402
                                       embed_utterance)
from parakeet_tpu_torch.nn.initializer import \
    init_flax_defaults_  # noqa: E402

FRAMES = (160, 300)
BUCKET = 8


def turn_ms(fn):
    """Milliseconds of ``fn()`` after one warm-up call (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--utterances", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this measurement needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    model = LSTMSpeakerEncoder()
    init_flax_defaults_(model, torch.Generator().manual_seed(args.seed))
    model.cuda().eval()
    rng = np.random.default_rng(args.seed)
    mels = [rng.standard_normal((int(rng.integers(FRAMES[0], FRAMES[1] + 1)),
                                 40)).astype(np.float32)
            for _ in range(args.utterances)]

    def padded(x):
        n = x.shape[0]
        pad = x.new_zeros((-(-n // BUCKET) * BUCKET - n, *x.shape[1:]))
        return model(torch.cat([x, pad]))[:n]

    out, ms = {}, {"as they are": [], "padded": []}
    for name in ("as they are", "padded", "padded", "as they are"):
        fn = padded if name == "padded" else None

        def run():
            out[name] = [embed_utterance(model, m, embed_fn=fn)
                         for m in mels]
        ms[name].append(turn_ms(run) / len(mels))
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(out["as they are"], out["padded"]))
    print(f"{len(mels)} utterances of {FRAMES[0]}-{FRAMES[1]} frames: "
          "partials as they are "
          + ", ".join(f"{t:.3f}" for t in ms["as they are"])
          + f" ms an utterance, padded to a multiple of {BUCKET} "
          + ", ".join(f"{t:.3f}" for t in ms["padded"])
          + f" ms; embeddings apart by {diff:.3g}")


if __name__ == "__main__":
    main()
