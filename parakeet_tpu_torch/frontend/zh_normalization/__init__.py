"""Chinese text normalization: the port's copy of
``parakeet_tpu/frontend/zh_normalization/__init__.py`` (pure Python)."""
from .char_convert import (simplified_to_traditional,
                           tranditional_to_simplified)
from .num import num2str, verbalize_cardinal, verbalize_digit
from .text_normlization import TextNormalizer

__all__ = ["TextNormalizer", "num2str", "verbalize_cardinal",
           "verbalize_digit", "tranditional_to_simplified",
           "simplified_to_traditional"]
