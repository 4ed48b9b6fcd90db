"""GE2E embedding export of the port (counterpart of
``recipes/ge2e/inference.py``; reference: examples/ge2e/inference.py:28 +
speaker_encoder.embed_utterance): mel .npy utterances -> speaker
embedding .npy.

Each utterance is split into partial windows of ``--partial-frames`` with
50% overlap, every partial is embedded, and the L2-normalised mean is the
utterance's embedding (``models/lstm_speaker_encoder.py::
embed_utterance``), which conditions the voice-cloning Tacotron2.  The
JAX recipe pads each utterance's partials to a multiple of 8 so that one
XLA compile serves every length and drops the padded rows' embeddings;
an eager PyTorch call compiles nothing per shape, so the port embeds the
utterance's partials as they are: the rows are independent, and the
embeddings are the same.  The checkpoint is any the JAX package or the
port writes (a train state's ``params`` or a bare parameter tree).

Usage:
  python -m parakeet_tpu_torch.recipes.ge2e.inference \\
      --checkpoint exp/checkpoints/snapshot_iter_N.npz \\
      --input dump/ge2e_mels --output dump/ge2e_embeds [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np

from ...bridge import load_checkpoint_params
from ...models import LSTMSpeakerEncoder, embed_utterance
from ...utils.device import add_device_arg, set_device

__all__ = ["main", "load_encoder"]


def load_encoder(checkpoint, device, **kwargs) -> LSTMSpeakerEncoder:
    """``LSTMSpeakerEncoder(**kwargs)`` with ``checkpoint``'s parameters,
    on ``device``, in eval mode."""
    model = LSTMSpeakerEncoder(**kwargs)
    load_checkpoint_params(model, checkpoint)
    return model.to(device).eval()


def main(argv=None):
    """Embed every ``.npy`` under ``--input`` with ``argv`` (default: the
    command line); returns {relative path: embedding}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--input", type=Path, required=True,
                        help="tree of mel .npy files (from preprocess.py)")
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--n-mels", type=int, default=40)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--hidden-size", type=int, default=256)
    parser.add_argument("--output-size", type=int, default=256)
    parser.add_argument("--partial-frames", type=int, default=160)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)

    model = load_encoder(args.checkpoint, device, n_mels=args.n_mels,
                         num_layers=args.num_layers,
                         hidden_size=args.hidden_size,
                         output_size=args.output_size)
    hop = args.partial_frames // 2
    out = {}
    for path in sorted(args.input.rglob("*.npy")):
        emb = embed_utterance(model, np.load(path),
                              partial_frames=args.partial_frames, hop=hop)
        rel = path.relative_to(args.input)
        dst = args.output / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        np.save(dst, emb.astype(np.float32))
        out[str(rel)] = emb
        print(f"{rel} -> {dst}")
    return out


if __name__ == "__main__":
    main()
