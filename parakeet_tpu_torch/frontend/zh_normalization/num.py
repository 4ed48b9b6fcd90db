"""Chinese number verbalization rules.

Equivalent of the reference rules (reference:
parakeet/frontend/zh_normalization/num.py, 249 LoC): cardinals, decimals,
fractions, percentages, ranges, negative numbers, and the "2 -> 两"
quantifier reading.

The port's copy of ``parakeet_tpu/frontend/zh_normalization/num.py`` (pure Python).
"""
from __future__ import annotations

import re

__all__ = [
    "num2str", "verbalize_cardinal", "verbalize_digit",
    "RE_NUMBER", "RE_FRAC", "RE_PERCENTAGE", "RE_RANGE", "RE_INTEGER",
    "RE_DEFAULT_NUM", "RE_POSITIVE_QUANTIFIERS", "RE_TWO", "RE_SCORE",
    "replace_number", "replace_frac", "replace_percentage",
    "replace_range", "replace_negative_num", "replace_default_num",
    "replace_positive_quantifier", "replace_score_or_time",
]

DIGITS = {str(i): c for i, c in enumerate("零一二三四五六七八九")}
UNITS = {1: "十", 2: "百", 3: "千", 4: "万", 8: "亿"}


def verbalize_digit(value_string: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading (phone numbers, IDs); 1 -> 幺 optionally."""
    result = "".join(DIGITS[d] for d in value_string if d in DIGITS)
    if alt_one:
        result = result.replace("一", "幺")
    return result


def _verbalize_section(section: str) -> str:
    """Verbalize a <10000 section, e.g. '2034' -> 二千零三十四."""
    n = int(section)
    if n == 0:
        return DIGITS["0"]
    out = []
    length = len(str(n))
    s = str(n)
    zero_pending = False
    for i, d in enumerate(s):
        pos = length - i - 1
        if d == "0":
            zero_pending = True
            continue
        if zero_pending and out:
            out.append(DIGITS["0"])
        zero_pending = False
        out.append(DIGITS[d])
        if pos in (1, 2, 3):
            out.append(UNITS[pos])
    word = "".join(out)
    # 一十X -> 十X
    if word.startswith("一十"):
        word = word[1:]
    return word


def verbalize_cardinal(value_string: str) -> str:
    """Cardinal reading of a non-negative integer string."""
    value_string = value_string.lstrip("0") or "0"
    n = int(value_string)
    if n == 0:
        return DIGITS["0"]
    # split into 万-scale sections of 4 digits
    s = str(n)
    sections = []
    while s:
        sections.append(s[-4:])
        s = s[:-4]
    # sections[0] = ones, [1] = 万, [2] = 亿, [3] = 万亿
    scale_names = ["", "万", "亿", "万亿"]
    out = []
    for i in reversed(range(len(sections))):
        sec = sections[i]
        if int(sec) == 0:
            continue
        word = _verbalize_section(sec)
        # inner zero padding between sections (e.g. 10005 -> 一万零五)
        if out and len(sec.lstrip("0")) < 4 and int(sec) != 0:
            out.append(DIGITS["0"])
        out.append(word + scale_names[i])
    return "".join(out) or DIGITS["0"]


def num2str(value_string: str) -> str:
    """Number string (may contain a decimal point) -> Chinese reading."""
    value_string = value_string.strip()
    if "." in value_string:
        integer, frac = value_string.split(".", 1)
        frac = frac.rstrip("0")
        integer_part = verbalize_cardinal(integer or "0")
        if frac:
            return integer_part + "点" + verbalize_digit(frac)
        return integer_part
    return verbalize_cardinal(value_string)


RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")
RE_RANGE = re.compile(r"(\d+(\.\d+)?)[~~—-](\d+(\.\d+)?)")
RE_INTEGER = re.compile(r"(-)(\d+)")
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")
# decimals only (the point is mandatory) — must run before the
# digit-by-digit RE_DEFAULT_NUM fallback (reference num.py:119)
RE_DECIMAL_NUM = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")
# measure-word alternation carried verbatim from the reference
# (num.py:31) — rule data
COM_QUANTIFIERS = '(朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|(公)分|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块|元|(亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|美|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)'  # noqa: data table
RE_POSITIVE_QUANTIFIERS = re.compile(r"(\d+)([多余几])?" + COM_QUANTIFIERS)
RE_TWO = re.compile("2")


def replace_frac(match) -> str:
    sign, num, den = match.group(1), match.group(2), match.group(3)
    return (("负" if sign else "") + num2str(den) + "分之" + num2str(num))


def replace_percentage(match) -> str:
    sign, pct = match.group(1), match.group(2)
    return ("负" if sign else "") + "百分之" + num2str(pct)


def replace_range(match) -> str:
    a, b = match.group(1), match.group(3)
    return num2str(a) + "到" + num2str(b)


def replace_negative_num(match) -> str:
    return "负" + num2str(match.group(2))


def replace_number(match) -> str:
    sign = match.group(1)
    number = match.group(2) or match.group(5)
    if number is None:
        return match.group(0)
    if number.startswith("."):
        return ("负" if sign else "") + "零" + num2str("0" + number)[1:]
    return ("负" if sign else "") + num2str(number)


_ARITH_CONTEXT = "加减乘除等于"


def replace_default_num(match) -> str:
    """Bare digit strings read digit-by-digit (IDs, codes, '985') —
    EXCEPT operands of an arithmetic expression ('123加456' ->
    一百二十三加四百五十六), which are quantities.  The reference reads
    all of them digit-by-digit (reference num.py:134) and mismatches
    its own labeled set on the arithmetic lines."""
    s = match.group(0)
    left = match.string[match.start() - 1:match.start()]
    right = match.string[match.end():match.end() + 1]
    if ((left in _ARITH_CONTEXT and left) or
            (right in _ARITH_CONTEXT and right)) and not s.startswith("0"):
        return num2str(s)
    return verbalize_digit(s)


# game scores: X:Y with a score-word left context, or a pair that
# cannot be a clock time (beyond-reference: the reference has no score
# rule and reads '37:16' through its time rule)
RE_SCORE = re.compile(r"(?<![\d.])(\d{1,3})[::](\d{1,3})(?![\d.])")
_SCORE_CONTEXT = ("比分", "比赛", "得分", "战胜", "领先", "落后", "大比分")


def replace_score_or_time(match) -> str:
    """X:Y -> X比Y when the left context names a score or the pair is
    not a valid clock time; otherwise pass through for the time rule."""
    a, b = int(match.group(1)), int(match.group(2))
    left = match.string[max(0, match.start() - 6):match.start()]
    if any(k in left for k in _SCORE_CONTEXT) or a > 24 or b > 59:
        return num2str(match.group(1)) + "比" + num2str(match.group(2))
    return match.group(0)


def replace_positive_quantifier(match) -> str:
    """'2个' -> 两个 etc."""
    number, suffix, quantifier = (match.group(1), match.group(2) or "",
                                  match.group(3))
    reading = num2str(number)
    if number == "2":
        reading = "两"
    return reading + suffix + quantifier
