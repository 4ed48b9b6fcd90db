"""CLI: a Paddle ConditionalWaveFlow checkpoint -> the port's checkpoint
.npz (counterpart of ``tools/convert_waveflow_checkpoint.py``).

Usage:
  python -m parakeet_tpu_torch.tools.convert_waveflow_checkpoint \\
      --input wf_paddle.npz --config recipes/waveflow/conf/default.yaml \\
      --output wf.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_waveflow, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__, "waveflow recipe yaml (model section)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("model", {})
    params = convert_waveflow(
        load_paddle_state(args.input), n_flows=cfg.get("n_flows", 8),
        n_layers=cfg.get("n_layers", 8),
        upsample_factors=tuple(cfg.get("upsample_factors", (16, 16))))
    return write(args.output, params)


if __name__ == "__main__":
    main()
