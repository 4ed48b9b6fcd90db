"""Chinese date/time verbalization rules (reference:
parakeet/frontend/zh_normalization/chronology.py).

The port's copy of ``parakeet_tpu/frontend/zh_normalization/chronology.py`` (pure Python).
"""
from __future__ import annotations

import re

from .num import verbalize_cardinal, verbalize_digit

__all__ = ["RE_DATE", "RE_DATE2", "RE_TIME", "RE_TIME_RANGE",
           "replace_date", "replace_date2", "replace_time"]

RE_DATE = re.compile(
    r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?(((0?[1-9])|((1|2)[0-9])|30|31)"
    r"([日号]))?")
RE_DATE2 = re.compile(
    r"(\d{4})([-/.])(0?[1-9]|1[0-2])\2(3[01]|[12][0-9]|0?[1-9])")
RE_TIME = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"(~|-)"
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")


def _year_to_words(year: str) -> str:
    return verbalize_digit(year) + "年"


def replace_date(match) -> str:
    year = match.group(1)
    month = match.group(3)
    day = match.group(5)
    out = ""
    if year:
        out += _year_to_words(year)
    if month:
        out += verbalize_cardinal(month) + "月"
    if day:
        out += verbalize_cardinal(day) + match.group(9)
    return out


def replace_date2(match) -> str:
    year, month, day = match.group(1), match.group(3), match.group(4)
    out = ""
    if year:
        out += _year_to_words(year)
    if month:
        out += verbalize_cardinal(month) + "月"
    if day:
        out += verbalize_cardinal(day) + "日"
    return out


def _time_words(h: str, m: str, s: str | None) -> str:
    # on-the-hour times read as bare 点 (reference chronology.py:36-53)
    out = verbalize_cardinal(h) + "点"
    if int(m) != 0:
        if int(m) < 10:
            out += "零"
        out += verbalize_cardinal(m) + "分"
    if s and int(s) != 0:
        out += verbalize_cardinal(s) + "秒"
    return out


def replace_time(match) -> str:
    groups = match.groups()
    h, m, s = groups[0], groups[1], groups[3]
    out = _time_words(h, m, s)
    if len(groups) > 5 and groups[5] is not None:   # range variant
        h2, m2, s2 = groups[5], groups[6], groups[8]
        out += "至" + _time_words(h2, m2, s2)
    return out
