"""Tacotron2 preprocessing in the port (counterpart of
``recipes/tacotron2/preprocess.py``): the TransformerTTS recipe's
pipeline (``transformer_tts/preprocess.py``) with the character frontend
as the default (reference analog: examples/tacotron2/preprocess.py pairs a
character frontend with mel extraction); ``--frontend phone`` still
selects ARPABET.  The output schema (text tokens + speech .npy + id map)
feeds the shared normalize stage and the train CLI.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2.preprocess \\
      --rootdir ~/datasets/LJSpeech-1.1 --dumpdir dump \\
      --config recipes/tacotron2/conf/default.yaml
"""
import sys

from ..transformer_tts import preprocess

__all__ = ["main"]


def main(argv=None) -> list:
    """``transformer_tts.preprocess.main`` on ``argv`` (default: the
    command line) with ``--frontend char`` added unless it names one."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--frontend" or a.startswith("--frontend=")
               for a in argv):
        argv += ["--frontend", "char"]
    return preprocess.main(argv)


if __name__ == "__main__":
    main()
