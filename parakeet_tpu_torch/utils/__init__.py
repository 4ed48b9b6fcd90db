"""Utilities of the port (counterparts of ``parakeet_tpu.utils``)."""
