"""A seeded synthetic dump in the TransformerTTS recipe's format, for smoke
runs and tests of the recipe without a corpus.

``recipes/transformer_tts/preprocess.py`` and its normalize stage write
what the Tacotron2 recipe reads: per split a ``metadata.jsonl`` whose
rows hold the token ids (``text``) and the path of the normalised mel
(``speech``, (frames, n_mels) ``.npy``), and a ``phone_id_map.txt`` whose
last id is ``<eos>``.  So the dump is the Tacotron2 recipe's
(``recipes/tacotron2/dump.py``): standard normal mels.
"""
from ..tacotron2.dump import write_synthetic_dump

__all__ = ["write_synthetic_dump"]
