"""GE2E speaker-encoder recipe (counterpart of ``recipes/ge2e``)."""
