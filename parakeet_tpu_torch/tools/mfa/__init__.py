"""The Montreal Forced Aligner's corpus tools of the port (counterparts of
``tools/mfa/*.py`` that use the JAX package): each runs as ``python -m
parakeet_tpu_torch.tools.mfa.<name>``.  ``tools/mfa/detect_oov.py``,
``reorganize_aishell3.py`` and ``reorganize_ljspeech.py`` use neither
package and serve both."""
