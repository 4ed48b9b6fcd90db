"""FastSpeech2 recipe (counterpart of ``recipes/fastspeech2``)."""
