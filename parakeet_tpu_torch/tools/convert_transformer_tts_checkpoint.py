"""CLI: a Paddle TransformerTTS checkpoint -> the port's checkpoint .npz
(counterpart of ``tools/convert_transformer_tts_checkpoint.py``).

Usage:
  python -m parakeet_tpu_torch.tools.convert_transformer_tts_checkpoint \\
      --input tt_paddle.npz \\
      --config recipes/transformer_tts/conf/default.yaml --output tt.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_transformer_tts, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__,
        "transformer_tts recipe yaml (model section)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("model", {})
    params, batch_stats = convert_transformer_tts(
        load_paddle_state(args.input),
        elayers=cfg.get("elayers", 6), dlayers=cfg.get("dlayers", 6),
        aheads=cfg.get("aheads", 8),
        dprenet_layers=cfg.get("dprenet_layers", 2),
        postnet_layers=cfg.get("postnet_layers", 5),
        reduction_factor=cfg.get("reduction_factor", 1))
    return write(args.output, params, batch_stats)


if __name__ == "__main__":
    main()
