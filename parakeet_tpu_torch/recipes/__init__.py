"""Recipe CLIs of the port (counterparts of ``recipes/``), and each
family's ``run.sh`` pipeline (the twin of ``recipes/<family>/run.sh``)."""
