"""English number verbalization, self-contained (no ``inflect``).

Equivalent of the reference's number expansion (reference:
parakeet/frontend/normalizer/numbers.py:77): money, ordinals, decimals,
years, plain cardinals — regex cascade over text.

The port's copy of ``parakeet_tpu/frontend/normalizer/numbers.py`` (pure Python).
"""
from __future__ import annotations

import re

__all__ = ["normalize_numbers", "number_to_words", "ordinal_to_words"]

_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine", "ten", "eleven", "twelve", "thirteen",
          "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
          "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"),
           (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    """Cardinal verbalization of a non-negative integer."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("-" + _UNITS[rem] if rem else "")
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            out = number_to_words(major) + " " + name
            if rem:
                out += " " + number_to_words(rem)
            return out
    return _UNITS[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    hy_head, _, hy_last = last.rpartition("-")
    target = hy_last
    if target in _ORDINAL_IRREGULAR:
        ord_last = _ORDINAL_IRREGULAR[target]
    elif target.endswith("y"):
        ord_last = target[:-1] + "ieth"
    else:
        ord_last = target + "th"
    last = (hy_head + "-" if hy_head else "") + ord_last
    return (head + " " if head else "") + last


def _year_to_words(n: int) -> str:
    if 1000 <= n < 2000 or 2010 <= n < 3000:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return number_to_words(hi) + " hundred"
        if lo < 10:
            return number_to_words(hi) + " oh " + number_to_words(lo)
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


_COMMA_NUMBER = re.compile(
    r"(?<![0-9])([0-9]{1,3}(?:,[0-9]{3})+(?:\.[0-9]+)?)(?![0-9])")
_POUNDS = re.compile(r"£([0-9,]*[0-9]+)")
_DOLLARS = re.compile(r"\$([0-9.,]*[0-9]+)")
_DECIMAL = re.compile(r"([0-9]+\.[0-9]+)")
_ORDINAL = re.compile(r"([0-9]+)(st|nd|rd|th)")
_YEAR = re.compile(r"\b([12][0-9]{3})\b")
_NUMBER = re.compile(r"[0-9]+")


def _expand_dollars(m):
    parts = m.group(1).replace(",", "").split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] \
        else 0
    out = []
    if dollars:
        out.append(number_to_words(dollars) + " dollar"
                   + ("s" if dollars != 1 else ""))
    if cents:
        out.append(number_to_words(cents) + " cent"
                   + ("s" if cents != 1 else ""))
    return " ".join(out) if out else "zero dollars"


def _expand_decimal(m):
    intpart, frac = m.group(1).split(".")
    return (number_to_words(int(intpart)) + " point "
            + " ".join(number_to_words(int(d)) for d in frac))


def _expand_comma_number(m):
    s = m.group(1).replace(",", "")
    if "." in s:
        intpart, frac = s.split(".")
        return (number_to_words(int(intpart)) + " point "
                + " ".join(number_to_words(int(d)) for d in frac))
    return number_to_words(int(s))


def normalize_numbers(text: str) -> str:
    # money first (their regexes accept the commas), then comma-grouped
    # numbers straight to cardinals: "1,234" is a quantity, never a year
    text = _POUNDS.sub(
        lambda m: number_to_words(int(m.group(1).replace(",", "")))
        + " pounds", text)
    text = _DOLLARS.sub(_expand_dollars, text)
    text = _COMMA_NUMBER.sub(_expand_comma_number, text)
    text = _DECIMAL.sub(_expand_decimal, text)
    text = _ORDINAL.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _YEAR.sub(lambda m: _year_to_words(int(m.group(1))), text)
    text = _NUMBER.sub(lambda m: number_to_words(int(m.group(0))), text)
    return text
