"""Command-line tools of the port (counterparts of the repository's
``tools/convert_*_checkpoint.py``, ``tools/verify_parity.py``,
``tools/op_table.py``, ``tools/gen_duration_from_textgrid.py``,
``tools/make_cmudict_eval.py`` and, under ``mfa/``, the Montreal Forced
Aligner's corpus tools): each runs as ``python -m
parakeet_tpu_torch.tools.<name>``."""
