"""Chinese telephone-number verbalization (reference:
parakeet/frontend/zh_normalization/phonecode.py).

The port's copy of ``parakeet_tpu/frontend/zh_normalization/phonecode.py`` (pure Python).
"""
from __future__ import annotations

import re

from .num import verbalize_digit

__all__ = ["RE_MOBILE_PHONE", "RE_TELEPHONE", "RE_NATIONAL_UNIFORM_NUMBER",
           "replace_phone", "replace_mobile"]

# mobile: optional +86, 1[3-9]xxxxxxxxx
RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)")
# landline: 0xx(x)-xxxxxxx(x)
RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2}))-?([1-9]\d{6,7}))(?!\d)")
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")


def _digits(text: str) -> str:
    # 1 reads as 一, not 幺: the reference verbalizes phone numbers
    # with 幺 (phonecode.py:25 alt_one=True) but its own labeled set
    # (textnorm_test_cases.txt) writes 一 — follow the labels
    return verbalize_digit(re.sub(r"\D", "", text), alt_one=False)


def replace_mobile(match) -> str:
    return _digits(match.group(0))


def replace_phone(match) -> str:
    return _digits(match.group(0))
