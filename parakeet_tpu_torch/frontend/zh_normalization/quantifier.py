"""Chinese measure-expression verbalization (reference:
parakeet/frontend/zh_normalization/quantifier.py).

The port's copy of ``parakeet_tpu/frontend/zh_normalization/quantifier.py`` (pure Python).
"""
from __future__ import annotations

import re

from .num import num2str

__all__ = ["RE_TEMPERATURE", "replace_temperature"]

RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")


def replace_temperature(match) -> str:
    sign = match.group(1)
    value = match.group(2)
    unit = match.group(4)
    # only the written word 摄氏度 reads as such; °C/℃ read plain 度
    # (reference quantifier.py:36)
    unit_word = "摄氏度" if unit == "摄氏度" else "度"
    return ("零下" if sign else "") + num2str(value) + unit_word
