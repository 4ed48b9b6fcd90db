"""CLI: a Paddle PWGGenerator checkpoint -> the port's checkpoint .npz
(counterpart of ``tools/convert_pwg_checkpoint.py``).

A dump of the whole GAN (keys under ``generator.``) is taken too: the
scope is stripped.  ``generator_params``' ``layers``,
``upsample_scales`` and ``nonlinear_activation`` set the layout.

Usage:
  # paddle side (once): np.savez("pwg_paddle.npz",
  #   **{k: np.asarray(v) for k, v in generator.state_dict().items()})
  python -m parakeet_tpu_torch.tools.convert_pwg_checkpoint \\
      --input pwg_paddle.npz --config recipes/pwgan/conf/default.yaml \\
      --output pwg.npz
"""
from pathlib import Path

from ..training.config import Config
from ..utils.convert import convert_pwg_generator, load_paddle_state
from ._convert import converter_parser, write

__all__ = ["main"]


def main(argv=None) -> Path:
    args = converter_parser(
        __doc__, "pwgan recipe yaml (generator_params)").parse_args(argv)
    cfg = Config.from_yaml(args.config).get("generator_params", {})
    state = load_paddle_state(args.input)
    if not any(k.startswith("first_conv") for k in state):
        state = {k.split(".", 1)[1]: v for k, v in state.items()
                 if k.startswith("generator.")}
    params = convert_pwg_generator(
        state, layers=cfg.get("layers", 30),
        upsample_scales=tuple(cfg.get("upsample_scales", (4, 5, 3, 5))),
        nonlinear_activation=bool(cfg.get("nonlinear_activation")))
    return write(args.output, params)


if __name__ == "__main__":
    main()
