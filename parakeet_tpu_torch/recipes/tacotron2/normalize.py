"""Tacotron2 normalization in the port (counterpart of
``recipes/tacotron2/normalize.py``): the TransformerTTS recipe's stage,
z-scored speech + token ids with train-set statistics
(``transformer_tts/normalize.py``), with the same flags.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2.normalize \\
      --metadata dump/metadata_train.jsonl --dumpdir dump_norm/train \\
      --phones-dict dump/phone_id_map.txt --stats-dir dump --compute-stats
"""
from ..transformer_tts.normalize import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
