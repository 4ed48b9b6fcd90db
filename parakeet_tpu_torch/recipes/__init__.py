"""Recipe CLIs of the port (counterparts of ``recipes/``)."""
