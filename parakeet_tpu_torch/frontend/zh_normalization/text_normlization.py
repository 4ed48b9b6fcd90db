"""Chinese text normalization pipeline.

Equivalent of the reference TextNormalizer (reference:
parakeet/frontend/zh_normalization/text_normlization.py:50-97 — the
filename spelling follows the reference): sentence split + regex cascade
over dates, times, temperatures, fractions, percentages, phone numbers,
ranges, negatives, decimals, quantifiers; full-width -> half-width;
traditional -> simplified.

The port's copy of ``parakeet_tpu/frontend/zh_normalization/text_normlization.py`` (pure Python).
"""
from __future__ import annotations

import re
from typing import List

from .char_convert import tranditional_to_simplified
from .chronology import (RE_DATE, RE_DATE2, RE_TIME, RE_TIME_RANGE,
                         replace_date, replace_date2, replace_time)
from .num import (RE_DECIMAL_NUM, RE_DEFAULT_NUM, RE_FRAC, RE_INTEGER,
                  RE_NUMBER,
                  RE_PERCENTAGE, RE_POSITIVE_QUANTIFIERS, RE_RANGE,
                  RE_SCORE,
                  replace_default_num, replace_frac, replace_negative_num,
                  replace_number, replace_percentage,
                  replace_positive_quantifier, replace_range,
                  replace_score_or_time)
from .phonecode import (RE_MOBILE_PHONE, RE_NATIONAL_UNIFORM_NUMBER,
                        RE_TELEPHONE, replace_mobile, replace_phone)
from .quantifier import RE_TEMPERATURE, replace_temperature

__all__ = ["TextNormalizer"]

SENTENCE_SPLITOR = re.compile(r"([：、，；。？！,;?!][”’]?)")


class TextNormalizer:
    def __init__(self):
        pass

    def _split(self, text: str, lang: str = "zh") -> List[str]:
        """Split long text into sentences at punctuation."""
        text = text.replace("\n", "").rstrip()
        text = SENTENCE_SPLITOR.sub(r"\1\n", text)
        sentences = [s.strip() for s in text.split("\n") if s.strip()]
        return sentences

    def _post_replace(self, sentence: str) -> str:
        sentence = sentence.replace("/", "每")
        sentence = sentence.replace("~", "至")
        return sentence

    def normalize_sentence(self, sentence: str) -> str:
        sentence = tranditional_to_simplified(sentence)
        # full-width letters/digits/space -> half-width; punctuation is
        # deliberately left full-width (the reference converts only
        # F2H_ASCII_LETTERS/F2H_DIGITS/F2H_SPACE, constants.py:21-41 —
        # Chinese 。，？ must survive for sentence splitting/prosody)
        f2h = {chr(0xFF21 + i): chr(0x41 + i) for i in range(26)}        # Ａ-Ｚ
        f2h.update({chr(0xFF41 + i): chr(0x61 + i) for i in range(26)})  # ａ-ｚ
        f2h.update({chr(0xFF10 + i): chr(0x30 + i) for i in range(10)})  # ０-９
        f2h["　"] = " "
        sentence = sentence.translate(str.maketrans(f2h))
        # order matters: most specific first
        sentence = RE_DATE.sub(replace_date, sentence)
        sentence = RE_DATE2.sub(replace_date2, sentence)
        # scores before times: '比分…37:16' must read 三十七比十六,
        # not fall into the clock-time rule (beyond-reference)
        sentence = RE_SCORE.sub(replace_score_or_time, sentence)
        sentence = RE_TIME_RANGE.sub(replace_time, sentence)
        sentence = RE_TIME.sub(replace_time, sentence)
        sentence = RE_TEMPERATURE.sub(replace_temperature, sentence)
        sentence = RE_FRAC.sub(replace_frac, sentence)
        sentence = RE_PERCENTAGE.sub(replace_percentage, sentence)
        sentence = RE_MOBILE_PHONE.sub(replace_mobile, sentence)
        sentence = RE_TELEPHONE.sub(replace_phone, sentence)
        sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(replace_phone, sentence)
        sentence = RE_RANGE.sub(replace_range, sentence)
        sentence = RE_INTEGER.sub(replace_negative_num, sentence)
        # decimals read as cardinals BEFORE the long-digit
        # digit-by-digit fallback claims them (reference order,
        # text_normlization.py:87)
        sentence = RE_DECIMAL_NUM.sub(replace_number, sentence)
        # quantified numbers read as cardinals BEFORE the long-digit
        # digit-by-digit fallback claims them
        sentence = RE_POSITIVE_QUANTIFIERS.sub(
            replace_positive_quantifier, sentence)
        sentence = RE_DEFAULT_NUM.sub(replace_default_num, sentence)
        sentence = RE_NUMBER.sub(replace_number, sentence)
        sentence = self._post_replace(sentence)
        return sentence

    def normalize(self, text: str) -> List[str]:
        return [self.normalize_sentence(s) for s in self._split(text)]
