"""Mandarin tone sandhi rules.

Equivalent of the reference ToneSandhi (reference:
parakeet/frontend/tone_sandhi.py:22-343): neutral-tone (轻声) rules,
不/一 sandhi, third-tone sandhi with jieba-based word splitting, and the
word-merge preprocessing pass (merge 不/一/reduplications/consecutive
third tones/儿 so the per-word rules can see across jieba boundaries).

Finals are Parakeet-style toned finals (e.g. ``ia1``, ``uen5``); tones are
the last character of each final.  The word lists live in
``_sandhi_data.py`` and are carried verbatim from the reference (rule
lists are data).

The port's copy of ``parakeet_tpu/frontend/tone_sandhi.py`` (pure Python).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ._sandhi_data import MUST_NEURAL_TONE_WORDS, MUST_NOT_NEURAL_TONE_WORDS

try:
    import jieba
    _HAS_JIEBA = True
except Exception:          # pragma: no cover - jieba is in the image
    jieba = None
    _HAS_JIEBA = False

__all__ = ["ToneSandhi"]

# sentence-final modal particles (reference tone_sandhi.py:87)
_MODAL_PARTICLES = set("吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶")
# structural particles, always neutral (reference tone_sandhi.py:89)
_DE_PARTICLES = set("的地得")
# characters that can take 个 as a classifier prefix (reference :104-106)
_GE_PREFIXES = set("几有两半多各整每做是上下这那哪")


def _set_tone(final: str, tone: str) -> str:
    return final[:-1] + tone


def _tone(final: str) -> str:
    return final[-1]


class ToneSandhi:
    """Rule-based Mandarin tone changes.

    ``finals_fn`` (optional) maps a word to its list of toned finals; it
    enables the consecutive-third-tone merge passes in
    :meth:`pre_merge_for_modify` (the reference uses pypinyin there,
    tone_sandhi.py:255-262 — here the frontend injects whichever G2P
    backend is live).
    """

    # 得-final words where 得 is the lexical verb de2 ("obtain"), not
    # the structural particle (赢得冠军 = ying2 de2, not de5)
    _DE_COMPOUNDS = frozenset({
        "赢得", "获得", "取得", "心得", "所得", "不得", "非得", "博得",
        "夺得", "难得", "使得", "值得", "得了",
    })

    # verb compounds whose 过 is lexical guo4, not the aspect particle
    _GUO_COMPOUNDS = frozenset({
        "经过", "通过", "难过", "不过", "超过", "度过", "渡过", "错过",
        "路过", "越过", "穿过", "透过", "绕过", "跨过", "胜过", "赛过",
        "放过", "闪过", "掠过", "飘过", "好过", "改过", "悔过", "走过",
    })

    def __init__(self, finals_fn: Optional[Callable[[str], List[str]]] = None):
        self.must_neural_tone_words = set(MUST_NEURAL_TONE_WORDS)
        self.must_not_neural_tone_words = set(MUST_NOT_NEURAL_TONE_WORDS)
        self._finals_fn = finals_fn

    # ---- individual rules (reference tone_sandhi.py:74-205) -----------
    def _neural_sandhi(self, word: str, pos: str,
                       finals: List[str]) -> List[str]:
        n = len(word)
        # reduplication of nouns/verbs/adjectives: 奶奶, 试试, 旺旺
        for i in range(1, n):
            if word[i] == word[i - 1] and pos[0] in ("n", "v", "a"):
                finals[i] = _set_tone(finals[i], "5")
        ge_idx = word.find("个")
        if n >= 1 and word[-1] in _MODAL_PARTICLES:
            finals[-1] = _set_tone(finals[-1], "5")
        # structural 的/地/得: particle segments (u*) and adverbials
        # (轻轻地 'z'/'d', 真的 'd') — NOT content nouns (墓地, 目的)
        elif (n >= 1 and word[-1] in _DE_PARTICLES
                and (pos[:1] == "u" or pos in ("d", "z", "ad"))
                and word not in self._DE_COMPOUNDS):
            finals[-1] = _set_tone(finals[-1], "5")
        # aspect particles standing alone: 走了, 看着, 去过
        elif n == 1 and word in "了着过" and pos in ("ul", "uz", "ug"):
            finals[-1] = _set_tone(finals[-1], "5")
        # aspect 过 folded into a verb segment (去过, 看过): neutral —
        # unless 过 is part of the compound itself (经过, 难过, ...).
        # The reference only handles 过 as its own segment (residual
        # class 3 in docs/frontend_accuracy.md, closed round 4).
        elif (n == 2 and word[-1] == "过" and pos[:1] == "v"
                and word not in self._GUO_COMPOUNDS):
            finals[-1] = _set_tone(finals[-1], "5")
        elif (n > 1 and word[-1] in "们子" and pos[:1] in ("r", "n")
                and word not in self.must_not_neural_tone_words):
            finals[-1] = _set_tone(finals[-1], "5")
        # 上/下/里 as locative suffix: 桌上, 地下, 家里
        elif n > 1 and word[-1] in "上下里" and pos in ("s", "l", "f"):
            finals[-1] = _set_tone(finals[-1], "5")
        # directional 来/去 after 上下进出回过起开
        elif n > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
            finals[-1] = _set_tone(finals[-1], "5")
        # 个 as classifier: 三个, 有个, or bare 个
        elif (ge_idx >= 1 and (word[ge_idx - 1].isnumeric()
                               or word[ge_idx - 1] in _GE_PREFIXES)) \
                or word == "个":
            finals[ge_idx] = _set_tone(finals[ge_idx], "5")
        else:
            if (word in self.must_neural_tone_words
                    or word[-2:] in self.must_neural_tone_words):
                finals[-1] = _set_tone(finals[-1], "5")

        # re-check each jieba sub-word against the must list (a merged
        # word like 一会儿工夫 still needs 工夫 neutralized)
        parts = self._split_word(word)
        if len(parts) == 2:
            split = len(parts[0])
            chunks = [finals[:split], finals[split:]]
            for i, part in enumerate(parts):
                if chunks[i] and (part in self.must_neural_tone_words
                                  or part[-2:] in self.must_neural_tone_words):
                    chunks[i][-1] = _set_tone(chunks[i][-1], "5")
            finals = chunks[0] + chunks[1]
        return finals

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        # X不X: 看不懂 -> neutral 不
        if len(word) == 3 and word[1] == "不":
            finals[1] = _set_tone(finals[1], "5")
        else:
            for i, ch in enumerate(word):
                if ch == "不" and i + 1 < len(word) and \
                        _tone(finals[i + 1]) == "4":
                    finals[i] = _set_tone(finals[i], "2")
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        # 一 inside a digit sequence keeps tone1: 一零零, 二一零
        if "一" in word and all(ch.isnumeric() for ch in word if ch != "一"):
            return finals
        # 一 between reduplicated verbs: 看一看 -> neutral
        if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
            finals[1] = _set_tone(finals[1], "5")
        # ordinal: 第一 keeps tone1
        elif word.startswith("第一"):
            finals[1] = _set_tone(finals[1], "1")
        else:
            for i, ch in enumerate(word):
                if ch == "一" and i + 1 < len(word):
                    if _tone(finals[i + 1]) == "4":
                        finals[i] = _set_tone(finals[i], "2")
                    else:
                        finals[i] = _set_tone(finals[i], "4")
        return finals

    def _split_word(self, word: str) -> List[str]:
        if not _HAS_JIEBA or len(word) < 2:
            return [word]
        parts = sorted(jieba.cut_for_search(word), key=len)
        if not parts or len(parts[0]) == len(word):
            return [word]
        first = parts[0]
        if word.startswith(first):
            return [first, word[len(first):]]
        return [word[:-len(first)], first]

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        n = len(word)
        if n == 2 and self._all_tone_three(finals):
            finals[0] = _set_tone(finals[0], "2")
        elif n == 3:
            parts = self._split_word(word)
            if self._all_tone_three(finals):
                if len(parts[0]) == 2:        # AA B -> 2 2 3 (蒙古/包)
                    finals[0] = _set_tone(finals[0], "2")
                    finals[1] = _set_tone(finals[1], "2")
                else:                          # A BB -> 3 2 3 (纸/老虎)
                    finals[1] = _set_tone(finals[1], "2")
            elif len(parts) == 2:
                split = len(parts[0])
                chunks = [finals[:split], finals[split:]]
                for i, sub in enumerate(chunks):
                    # a fully-third-tone disyllabic sub-word: 所有/人
                    if len(sub) == 2 and self._all_tone_three(sub):
                        sub[0] = _set_tone(sub[0], "2")
                    # 3-3 across the sub-word boundary: 好/喜欢
                    elif (i == 1 and sub and not self._all_tone_three(sub)
                            and _tone(sub[0]) == "3"
                            and chunks[0] and _tone(chunks[0][-1]) == "3"):
                        chunks[0][-1] = _set_tone(chunks[0][-1], "2")
                finals = chunks[0] + chunks[1]
        elif n == 4:                           # idiom: split 2 + 2
            for start in (0, 2):
                sub = finals[start:start + 2]
                if self._all_tone_three(sub):
                    finals[start] = _set_tone(finals[start], "2")
        return finals

    @staticmethod
    def _all_tone_three(finals: List[str]) -> bool:
        return bool(finals) and all(_tone(f) == "3" for f in finals)

    # ---- segment merge passes (reference tone_sandhi.py:209-334) -------
    @staticmethod
    def _is_reduplication(word: str) -> bool:
        return len(word) == 2 and word[0] == word[1]

    @staticmethod
    def _merge_bu(seg: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        """Attach a dangling 不 to the following word (看 不 懂 -> 看 不懂)."""
        out: List[Tuple[str, str]] = []
        pending = False
        for word, pos in seg:
            if pending:
                word = "不" + word
                pending = False
            if word == "不":
                pending = True
            else:
                out.append((word, pos))
        if pending:
            out.append(("不", "d"))
        return out

    @staticmethod
    def _merge_yi(seg: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        """听 一 听 -> 听一听; also glue a dangling 一 onto the next word."""
        out: List[Tuple[str, str]] = []
        i = 0
        while i < len(seg):
            word, pos = seg[i]
            if (word == "一" and out and i + 1 < len(seg)
                    and seg[i - 1][0] == seg[i + 1][0]
                    and seg[i - 1][1] == "v"):
                prev, ppos = out.pop()
                out.append((prev + "一" + seg[i + 1][0], ppos))
                i += 2
                continue
            out.append((word, pos))
            i += 1
        merged: List[Tuple[str, str]] = []
        for word, pos in out:
            if merged and merged[-1][0] == "一":
                merged[-1] = ("一" + word, pos)
            else:
                merged.append((word, pos))
        return merged

    @staticmethod
    def _merge_reduplication(
            seg: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for word, pos in seg:
            if out and word == out[-1][0]:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    def _word_finals(self, word: str) -> Optional[List[str]]:
        if self._finals_fn is None:
            return None
        try:
            finals = self._finals_fn(word)
        except Exception:
            return None
        if not finals:
            return None
        # neutral-tone preview: the reference's pypinyin already returns
        # zi5 for 孩子 here, so its merge passes never see the citation
        # zi3 and won't glue 孩子+把; our raw G2P is citation-toned, so
        # apply the must-neutral table before the tone-3 checks
        if (word in self.must_neural_tone_words
                or word[-2:] in self.must_neural_tone_words
                or (len(word) > 1 and word[-1] in "们子"
                    and word not in self.must_not_neural_tone_words)):
            finals[-1] = _set_tone(finals[-1], "5")
        return finals

    def _merge_three_tones(self, seg: List[Tuple[str, str]],
                           whole_word: bool) -> List[Tuple[str, str]]:
        """Merge neighbors that form a 3-3 pattern so _three_sandhi can
        fix them.  ``whole_word``: both words entirely third-tone
        (reference :253-278); else only the boundary syllables
        (reference :283-305)."""
        finals_list = [self._word_finals(w) for w, _ in seg]
        if any(f is None for f in finals_list):
            return seg
        out: List[Tuple[str, str]] = []
        merged_prev = False
        for i, (word, pos) in enumerate(seg):
            if whole_word:
                hit = (i > 0 and self._all_tone_three(finals_list[i - 1])
                       and self._all_tone_three(finals_list[i]))
            else:
                hit = (i > 0 and _tone(finals_list[i - 1][-1]) == "3"
                       and _tone(finals_list[i][0]) == "3")
            if hit and not merged_prev and out \
                    and not self._is_reduplication(seg[i - 1][0]) \
                    and len(seg[i - 1][0]) + len(word) <= 3:
                out[-1] = (out[-1][0] + word, out[-1][1])
                merged_prev = True
            else:
                out.append((word, pos))
                merged_prev = False
        return out

    @staticmethod
    def _merge_er(seg: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for word, pos in seg:
            if out and word == "儿":
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    # ---- public API ----------------------------------------------------
    def pre_merge_for_modify(
            self, seg: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        """Merge 不/一, reduplications, consecutive third tones and 儿
        with their neighbors so the per-word rules can see them
        (reference tone_sandhi.py:327-334)."""
        seg = self._merge_bu(seg)
        seg = self._merge_yi(seg)
        seg = self._merge_reduplication(seg)
        seg = self._merge_three_tones(seg, whole_word=True)
        seg = self._merge_three_tones(seg, whole_word=False)
        seg = self._merge_er(seg)
        return seg

    def modified_tone(self, word: str, pos: str,
                      finals: List[str]) -> List[str]:
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        return finals
