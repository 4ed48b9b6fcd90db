"""GE2E-conditioned Tacotron2 on AISHELL-3, the voice-cloning recipe
(counterpart of ``recipes/tacotron2_aishell3``)."""
