"""SpeedySpeech recipe (counterpart of ``recipes/speedyspeech``)."""
