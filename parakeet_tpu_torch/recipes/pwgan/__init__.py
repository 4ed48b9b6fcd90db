"""Parallel WaveGAN recipe (counterpart of ``recipes/pwgan``)."""
