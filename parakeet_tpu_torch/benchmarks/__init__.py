"""Benchmarks of the port (counterparts of ``benchmarks/``)."""
