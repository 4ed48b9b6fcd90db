"""CLI: a Paddle FastSpeech2 checkpoint -> the port's checkpoint .npz
(counterpart of ``tools/convert_fastspeech2_checkpoint.py``).

A dump whose keys carry a scope (no key starts with ``encoder.``) loses
each key's first part.  The ``model`` section's layer counts and heads
set the layout.

Usage:
  # paddle side (once): np.savez("fs2_paddle.npz",
  #   **{k: np.asarray(v) for k, v in model.state_dict().items()})
  python -m parakeet_tpu_torch.tools.convert_fastspeech2_checkpoint \\
      --input fs2_paddle.npz \\
      --config recipes/fastspeech2/conf/default.yaml --output fs2.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_fastspeech2, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__, "fastspeech2 recipe yaml (model section)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("model", {})
    state = load_paddle_state(args.input)
    if not any(k.startswith("encoder.") for k in state):
        state = {k.split(".", 1)[1]: v for k, v in state.items()
                 if "." in k}
    params, batch_stats = convert_fastspeech2(
        state,
        elayers=cfg.get("elayers", 4),
        dlayers=cfg.get("dlayers", 4),
        aheads=cfg.get("aheads", 2),
        postnet_layers=cfg.get("postnet_layers", 5),
        predictor_layers=cfg.get("duration_predictor_layers", 2),
        pitch_predictor_layers=cfg.get("pitch_predictor_layers", 5),
        energy_predictor_layers=cfg.get("energy_predictor_layers", 2))
    return write(args.output, params, batch_stats)


if __name__ == "__main__":
    main()
