"""WaveFlow preprocessing in the port (counterpart of
``recipes/waveflow/preprocess.py``): the same (wave, log-mel) dumps as the
PWGAN recipe (reference: examples/waveflow/preprocess.py extracts the
same pairs), so this is the PWGAN preprocessing's ``main`` with the same
flags; both vocoders train from the same metadata schema.

Usage:
  python -m parakeet_tpu_torch.recipes.waveflow.preprocess --rootdir wavs/ \\
      --dumpdir dump --config recipes/waveflow/conf/default.yaml
"""
from ..pwgan.preprocess import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
