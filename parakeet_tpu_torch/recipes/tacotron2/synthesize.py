"""Tacotron2 batch synthesis from a normalized dump in the port: token ids
-> mel -> wav (counterpart of ``recipes/tacotron2/synthesize.py``;
reference: examples/tacotron2/synthesize.py).

Each row of ``--test-metadata`` gives its token ids (``text``), cut to
``--max-text-len``.  ``Tacotron2.infer`` decodes them free-running at the
static shape (1, ``--max-text-len``) over exactly
``--max-decoder-steps`` steps, ending each utterance at its stop token or
attention peak: on the card one CUDA graph, captured once and replayed
for every row, the prenet's always-on dropout masks drawn once from seed
0.  The mel is cut to the decoded frames and ``--stat`` undoes its
normalisation.  With ``--pwg-*`` Parallel WaveGAN (kernel K1 on the
card), else with ``--waveflow-*`` WaveFlow, vocodes the frames eagerly
(``transformer_tts/synthesize_e2e.py::build_vocoder``; a row's length
changes the shape, so neither is one graph), on noise from a generator
seeded 0 for every row; without a vocoder the mel is written as
``<utt>.npy``.

TF32 is off.  Each row prints its frames and the host-clock times
(synchronised) of the decode and the vocoder; ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2.synthesize \\
      --config recipes/tacotron2/conf/default.yaml \\
      --checkpoint exp/checkpoints/snapshot_iter_N.npz \\
      --test-metadata dump_norm/test/metadata.jsonl \\
      --phones-dict dump/phone_id_map.txt \\
      --waveflow-config recipes/waveflow/conf/default.yaml \\
      --waveflow-checkpoint .../snapshot_iter_M.npz --output-dir wavs \\
      [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from ...bridge import load_checkpoint_params
from ...data.datatable import read_jsonl
from ...models import Tacotron2
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..common import count_lines
from ..synthesis import Stopwatch, TextProgram
from ..transformer_tts.synthesize import synthesize_rows
from ..transformer_tts.synthesize_e2e import MASK_SEED, build_vocoder

__all__ = ["main", "decode_program"]


def decode_program(model: Tacotron2, max_text_len: int, steps: int,
                   device: torch.device) -> TextProgram:
    """``Tacotron2.infer`` over exactly ``steps`` decoder steps at (1,
    ``max_text_len``), returning (mel_outputs_postnet, lengths): one CUDA
    graph on the card, else eager.  The prenet's masks are drawn once
    from seed ``MASK_SEED``."""
    inputs = {"text": torch.zeros((1, max_text_len), dtype=torch.int64,
                                  device=device),
              "text_lengths": torch.zeros((1,), dtype=torch.int64,
                                          device=device)}
    keep = model.prenet_masks(1, steps,
                              torch.Generator().manual_seed(MASK_SEED), "cpu")
    if keep is not None:
        inputs["prenet_keep"] = keep.to(device)

    def infer(text, text_lengths, prenet_keep=None):
        out = model.infer(text, text_lengths, max_decoder_steps=steps,
                          prenet_keep=prenet_keep)
        return out["mel_outputs_postnet"], out["lengths"]

    return TextProgram(infer, inputs, graph=device.type == "cuda")


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "sample_rate", "lines": [{utt_id, ids, frames, samples,
    am_s, vocoder_s, path, mel, wav}], "program"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stat", type=Path, default=None,
                        help="mel z-score stats .npy for denormalization")
    parser.add_argument("--test-metadata", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--pwg-config", type=Path, default=None)
    parser.add_argument("--pwg-checkpoint", type=Path, default=None)
    parser.add_argument("--waveflow-config", type=Path, default=None)
    parser.add_argument("--waveflow-checkpoint", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-text-len", type=int, default=192)
    parser.add_argument("--max-decoder-steps", type=int, default=1000)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    for name in ("pwg", "waveflow"):
        if ((getattr(args, f"{name}_config") is None)
                != (getattr(args, f"{name}_checkpoint") is None)):
            parser.error(f"--{name}-config and --{name}-checkpoint must be "
                         "given together")
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    model = Tacotron2(vocab_size=count_lines(args.phones_dict),
                      **inference_model_kwargs(cfg.get("model", {})))
    load_checkpoint_params(model, args.checkpoint)
    model.to(device).eval()
    norm = ZScore(*np.load(args.stat)).to(device) if args.stat else None
    vocoder, fs = build_vocoder(args, device)

    clock = Stopwatch(device)
    program = decode_program(model, args.max_text_len,
                             args.max_decoder_steps, device)
    capture_s = clock.seconds()
    lines = synthesize_rows(read_jsonl(args.test_metadata), program, norm,
                            vocoder, fs, args.max_text_len, args.output_dir,
                            device)
    return {"capture_s": capture_s, "sample_rate": fs, "lines": lines,
            "program": program}


if __name__ == "__main__":
    main()
