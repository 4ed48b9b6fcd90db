"""What the ``convert_*_checkpoint`` CLIs share: the flags of the JAX
package's CLIs (``--input``, ``--config``, ``--output``) and the write."""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from ..training.checkpoint import save_pytree
from ..utils.convert import checkpoint_arrays

__all__ = ["converter_parser", "write"]


def converter_parser(doc: str, config_help: Optional[str]
                     ) -> argparse.ArgumentParser:
    """A parser with ``--input`` and ``--output``, and ``--config`` unless
    ``config_help`` is None."""
    parser = argparse.ArgumentParser(
        description=doc.split("\n\n")[0], epilog=doc.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", type=Path, required=True,
                        help=".npz/.pkl dump of the Paddle state dict")
    if config_help is not None:
        parser.add_argument("--config", type=Path, required=True,
                            help=config_help)
    parser.add_argument("--output", type=Path, required=True)
    return parser


def write(path: Path, params, batch_stats=None) -> Path:
    """Save the converted trees as a checkpoint at ``path``."""
    save_pytree(path, checkpoint_arrays(params, batch_stats))
    print(f"wrote {path}")
    return path
