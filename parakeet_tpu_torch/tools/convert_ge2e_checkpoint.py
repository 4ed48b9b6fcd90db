"""CLI: a Paddle LSTMSpeakerEncoder (GE2E) checkpoint -> the port's
checkpoint .npz (counterpart of ``tools/convert_ge2e_checkpoint.py``).

Usage:
  python -m parakeet_tpu_torch.tools.convert_ge2e_checkpoint \\
      --input ge2e_paddle.npz [--num-layers 3] --output ge2e.npz
"""
from pathlib import Path

from ..utils.convert import convert_ge2e, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    parser = converter_parser(__doc__, None)
    parser.add_argument("--num-layers", type=int, default=3)
    args = parser.parse_args(argv)
    params = convert_ge2e(load_paddle_state(args.input),
                          num_layers=args.num_layers)
    return write(args.output, params)


if __name__ == "__main__":
    main()
