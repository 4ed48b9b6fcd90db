"""Tacotron2 recipe (counterpart of ``recipes/tacotron2``)."""
