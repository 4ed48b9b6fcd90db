"""Command-line tools of the port (counterparts of the repository's
``tools/convert_*_checkpoint.py`` and ``tools/verify_parity.py``): each
runs as ``python -m parakeet_tpu_torch.tools.<name>``."""
