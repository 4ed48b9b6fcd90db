"""CLI: a Paddle Tacotron2 checkpoint -> the port's checkpoint .npz
(counterpart of ``tools/convert_tacotron2_checkpoint.py``).

The convolutions' biases fold into the BatchNorm means; the tone
embedding is converted when the dump has one.

Usage:
  python -m parakeet_tpu_torch.tools.convert_tacotron2_checkpoint \\
      --input t2_paddle.npz --config recipes/tacotron2/conf/default.yaml \\
      --output t2.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_tacotron2, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__, "tacotron2 recipe yaml (model section)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("model", {})
    state = load_paddle_state(args.input)
    params, batch_stats = convert_tacotron2(
        state,
        encoder_conv_layers=cfg.get("encoder_conv_layers", 3),
        postnet_conv_layers=cfg.get("postnet_conv_layers", 5),
        use_stop_token=bool(cfg.get("use_stop_token", False)),
        toned="embedding_tones.weight" in state)
    return write(args.output, params, batch_stats)


if __name__ == "__main__":
    main()
