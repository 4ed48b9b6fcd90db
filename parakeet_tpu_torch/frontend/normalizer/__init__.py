"""English text normalization: the port's copy of
``parakeet_tpu/frontend/normalizer/__init__.py`` (pure Python)."""
from .abbreviations import expand_abbreviations
from .normalizer import full_to_half_width, half_to_full_width, normalize
from .numbers import normalize_numbers, number_to_words, ordinal_to_words

__all__ = ["normalize", "full_to_half_width", "half_to_full_width",
           "expand_abbreviations",
           "normalize_numbers", "number_to_words", "ordinal_to_words"]
