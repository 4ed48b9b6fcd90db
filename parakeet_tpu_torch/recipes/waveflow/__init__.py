"""WaveFlow recipe (counterpart of ``recipes/waveflow``)."""
