"""GE2E-conditioned Tacotron2 training on AISHELL-3, the voice-cloning
recipe's CLI in the port (counterpart of
``recipes/tacotron2_aishell3/train.py``; reference:
examples/tacotron2_aishell3/train.py:36 + aishell3.py:31-56).

Each row of the dump carries the path of a precomputed GE2E utterance
embedding (``spk_emb``, from ``recipes/ge2e/inference.py``) that
conditions the encoder (the YAML's ``d_global_condition``, 256).
``recipes/tacotron2_aishell3/conf/default.yaml`` runs unchanged: full
widths, the stop token off (the attention peak ends a decode), guided
attention on, batch 32.  The CLI is the Tacotron2 recipe's
(``recipes/tacotron2/train.py::main``): its batch function, which stacks
``spk_emb``, its updater, the evaluator and a snapshot every epoch,
resuming bit for bit under ``deterministic_training``.

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2_aishell3.train \\
      --config recipes/tacotron2_aishell3/conf/default.yaml \\
      --train-metadata dump/metadata_train.jsonl \\
      --dev-metadata dump/metadata_dev.jsonl \\
      --phones-dict dump/phone_id_map.txt --output-dir exp/vc [--device cpu]

Not ported: the JAX recipe's ``--dp`` (data parallelism; ROADMAP queue
1, item 18), ``--profiler-options``, its TensorBoard writer and the
alignment figures (item 8).
"""
from ..tacotron2.train import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
