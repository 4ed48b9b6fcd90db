"""TransformerTTS recipe (counterpart of ``recipes/transformer_tts``)."""
