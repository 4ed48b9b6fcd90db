"""CLI: a Paddle SpeedySpeech checkpoint -> the port's checkpoint .npz
(counterpart of ``tools/convert_speedyspeech_checkpoint.py``).

The ``model`` section's dilations set the layout; the tone embedding is
converted when the dump has one.

Usage:
  python -m parakeet_tpu_torch.tools.convert_speedyspeech_checkpoint \\
      --input ss_paddle.npz \\
      --config recipes/speedyspeech/conf/default.yaml --output ss.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_speedyspeech, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__, "speedyspeech recipe yaml (model section)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("model", {})
    state = load_paddle_state(args.input)
    params, batch_stats = convert_speedyspeech(
        state,
        encoder_dilations=tuple(cfg.get(
            "encoder_dilations", (1, 3, 9, 27, 1, 3, 9, 27, 1, 1))),
        decoder_dilations=tuple(cfg.get(
            "decoder_dilations",
            (1, 3, 9, 27, 1, 3, 9, 27, 1, 3, 9, 27, 1, 3, 9, 27, 1, 1))),
        tone="encoder.embedding.tone_embedding.weight" in state)
    return write(args.output, params, batch_stats)


if __name__ == "__main__":
    main()
