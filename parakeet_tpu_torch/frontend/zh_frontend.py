"""Chinese text -> phone(+tone) ids: the production zh pipeline.

Equivalent of the reference Frontend (reference:
parakeet/frontend/zh_frontend.py:30-254): TextNormalizer -> jieba posseg
segmentation -> ToneSandhi pre-merge -> per-word G2P (pinyin) -> tone
sandhi -> pinyin -> (initial, final+tone) phones -> ids.

G2P backends (the reference uses pypinyin/g2pM; neither ships in this
image), in priority order:
1. ``pypinyin`` if importable,
2. a user-supplied word/char -> pinyin lexicon file (``词 ci2`` or
   ``词语 ci2 yu3`` per line),
3. a built-in table of ~400 high-frequency characters (demo fallback —
   raises on uncovered characters unless ``strict=False``).

The port's copy of ``parakeet_tpu/frontend/zh_frontend.py`` (pure Python).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from .generate_lexicon import syllable_to_phones
from .tone_sandhi import ToneSandhi
from .zh_normalization import TextNormalizer

try:
    import jieba.posseg as psg
    _HAS_JIEBA = True
except Exception:              # pragma: no cover
    psg = None
    _HAS_JIEBA = False

__all__ = ["Frontend"]

_CHINESE = re.compile(r"[一-鿿]")


# verb+complement units jieba tends to split whose first char is a
# polyphone only resolvable in this context (WORD_PINYIN carries the
# readings); joined back before G2P in _g2p_sentence
_SPLIT_POLYPHONE_WORDS = frozenset({"长得", "长大", "觉得", "数不清"})

# single-char polyphones whose reading follows the jieba POS: the
# structural particles 地/得 (u*) read de5 (their char-table defaults
# are the content readings di4/de2), verbs 种/数 (v*) read zhong4/shu3
_POS_CHAR_PINYIN = {
    ("地", "u"): "de5", ("得", "u"): "de5",
    ("种", "v"): "zhong4", ("数", "v"): "shu3",
    ("教", "v"): "jiao1", ("量", "v"): "liang2",
}


def _cross_word_three_sandhi(word_sylls: List[Optional[List[str]]]) -> None:
    """Cross-word 3-3 sandhi the ≤3-char merge window misses, in place.

    Per-word ``_three_sandhi`` resolves in-word pairs and the merge
    passes (reference tone_sandhi.py:254-307) the short all-tone-3
    cross-word ones; what remains is pairs like 很|有意思 where the
    combined word exceeds the window.  Sandhi there is obligatory only
    when the left word cliticizes to the right — a monosyllabic
    modifier/pronoun (很, 我, 好...) — while across larger left words a
    prosodic boundary usually blocks it (七点|起床 keeps dian3); the
    rule fires only in the monosyllable case, and ``None`` entries
    (punctuation pauses) block it entirely.  The left word must also be
    a content-class monosyllable (pronoun/adverb/verb/adjective) — a
    locative/particle (动物园|里|有) hosts a prosodic break instead.
    """
    for i, (py, pos) in enumerate(word_sylls[:-1]):
        nxt = word_sylls[i + 1][0]
        # `py`/`nxt` can be [] under strict=False G2P (unknown chars
        # yield no syllables) — an empty result blocks sandhi like a
        # pause does.
        if (py and nxt and len(py) == 1
                and pos[:1] in ("r", "d", "v", "a", "z")
                and py[0].endswith("3") and nxt[0].endswith("3")):
            py[0] = py[0][:-1] + "2"

# high-frequency character -> toned pinyin (demo-scale built-in table)
_BUILTIN_PINYIN: Dict[str, str] = {
    "的": "de5", "一": "yi1", "是": "shi4", "了": "le5", "我": "wo3",
    "不": "bu4", "人": "ren2", "在": "zai4", "他": "ta1", "有": "you3",
    "这": "zhe4", "个": "ge4", "上": "shang4", "们": "men5", "来": "lai2",
    "到": "dao4", "时": "shi2", "大": "da4", "地": "di4", "为": "wei4",
    "子": "zi3", "中": "zhong1", "你": "ni3", "说": "shuo1", "生": "sheng1",
    "国": "guo2", "年": "nian2", "着": "zhe5", "就": "jiu4", "那": "na4",
    "和": "he2", "要": "yao4", "她": "ta1", "出": "chu1", "也": "ye3",
    "得": "de2", "里": "li3", "后": "hou4", "自": "zi4", "以": "yi3",
    "会": "hui4", "家": "jia1", "可": "ke3", "下": "xia4", "而": "er2",
    "过": "guo4", "天": "tian1", "去": "qu4", "能": "neng2", "对": "dui4",
    "小": "xiao3", "多": "duo1", "然": "ran2", "于": "yu2", "心": "xin1",
    "学": "xue2", "么": "me5", "之": "zhi1", "都": "dou1", "好": "hao3",
    "看": "kan4", "起": "qi3", "发": "fa1", "当": "dang1", "没": "mei2",
    "成": "cheng2", "只": "zhi3", "如": "ru2", "事": "shi4", "把": "ba3",
    "还": "hai2", "用": "yong4", "第": "di4", "样": "yang4", "道": "dao4",
    "想": "xiang3", "作": "zuo4", "种": "zhong3", "开": "kai1",
    "美": "mei3", "总": "zong3", "从": "cong2", "无": "wu2", "情": "qing2",
    "己": "ji3", "面": "mian4", "最": "zui4", "女": "nv3", "但": "dan4",
    "现": "xian4", "前": "qian2", "些": "xie1", "所": "suo3", "同": "tong2",
    "日": "ri4", "手": "shou3", "又": "you4", "行": "xing2", "意": "yi4",
    "动": "dong4", "方": "fang1", "期": "qi1", "它": "ta1", "头": "tou2",
    "经": "jing1", "长": "chang2", "儿": "er2", "回": "hui2", "位": "wei4",
    "分": "fen1", "爱": "ai4", "老": "lao3", "因": "yin1", "很": "hen3",
    "给": "gei3", "名": "ming2", "法": "fa3", "间": "jian1", "斯": "si1",
    "知": "zhi1", "世": "shi4", "什": "shen2", "两": "liang3", "次": "ci4",
    "身": "shen1", "者": "zhe3", "被": "bei4", "高": "gao1", "已": "yi3",
    "亲": "qin1", "其": "qi2", "进": "jin4", "此": "ci3", "话": "hua4",
    "常": "chang2", "与": "yu3", "活": "huo2", "正": "zheng4",
    "感": "gan3", "见": "jian4", "明": "ming2", "问": "wen4", "力": "li4",
    "理": "li3", "尔": "er3", "点": "dian3", "文": "wen2", "几": "ji3",
    "定": "ding4", "本": "ben3", "公": "gong1", "特": "te4", "做": "zuo4",
    "外": "wai4", "孩": "hai2", "相": "xiang1", "西": "xi1", "果": "guo3",
    "走": "zou3", "将": "jiang1", "月": "yue4", "十": "shi2", "实": "shi2",
    "向": "xiang4", "声": "sheng1", "车": "che1", "全": "quan2",
    "信": "xin4", "重": "zhong4", "三": "san1", "机": "ji1", "工": "gong1",
    "物": "wu4", "气": "qi4", "每": "mei3", "并": "bing4", "别": "bie2",
    "真": "zhen1", "打": "da3", "太": "tai4", "新": "xin1", "比": "bi3",
    "才": "cai2", "便": "bian4", "夫": "fu1", "再": "zai4", "书": "shu1",
    "部": "bu4", "水": "shui3", "像": "xiang4", "眼": "yan3", "等": "deng3",
    "体": "ti3", "却": "que4", "加": "jia1", "电": "dian4", "主": "zhu3",
    "界": "jie4", "门": "men2", "利": "li4", "海": "hai3", "受": "shou4",
    "听": "ting1", "表": "biao3", "德": "de2", "少": "shao3", "克": "ke4",
    "代": "dai4", "员": "yuan2", "许": "xu3", "先": "xian1", "口": "kou3",
    "由": "you2", "死": "si3", "安": "an1", "写": "xie3", "性": "xing4",
    "马": "ma3", "光": "guang1", "白": "bai2", "或": "huo4", "住": "zhu4",
    "难": "nan2", "望": "wang4", "教": "jiao4", "命": "ming4", "花": "hua1",
    "结": "jie2", "乐": "le4", "色": "se4", "更": "geng4", "拉": "la1",
    "东": "dong1", "神": "shen2", "记": "ji4", "处": "chu4", "让": "rang4",
    "母": "mu3", "父": "fu4", "应": "ying1", "直": "zhi2", "字": "zi4",
    "场": "chang3", "平": "ping2", "报": "bao4", "友": "you3",
    "关": "guan1", "放": "fang4", "至": "zhi4", "张": "zhang1",
    "认": "ren4", "接": "jie1", "告": "gao4", "入": "ru4", "笑": "xiao4",
    "内": "nei4", "英": "ying1", "军": "jun1", "候": "hou4", "民": "min2",
    "岁": "sui4", "往": "wang3", "何": "he2", "度": "du4", "山": "shan1",
    "觉": "jue2", "路": "lu4", "带": "dai4", "万": "wan4", "男": "nan2",
    "边": "bian1", "风": "feng1", "解": "jie3", "叫": "jiao4", "任": "ren4",
    "金": "jin1", "快": "kuai4", "原": "yuan2", "吃": "chi1", "妈": "ma1",
    "变": "bian4", "通": "tong1", "师": "shi1", "立": "li4", "象": "xiang4",
    "数": "shu4", "四": "si4", "失": "shi1", "满": "man3", "战": "zhan4",
    "远": "yuan3", "格": "ge2", "士": "shi4", "音": "yin1", "轻": "qing1",
    "目": "mu4", "条": "tiao2", "呢": "ne5", "病": "bing4", "始": "shi3",
    "达": "da2", "深": "shen1", "完": "wan2", "今": "jin1", "提": "ti2",
    "求": "qiu2", "清": "qing1", "王": "wang2", "化": "hua4", "空": "kong1",
    "业": "ye4", "思": "si1", "切": "qie4", "怎": "zen3", "非": "fei1",
    "找": "zhao3", "片": "pian4", "罗": "luo2", "钱": "qian2", "吗": "ma5",
    "语": "yu3", "元": "yuan2", "喜": "xi3", "曾": "ceng2", "离": "li2",
    "飞": "fei1", "科": "ke1", "言": "yan2", "证": "zheng4", "南": "nan2",
    "北": "bei3", "京": "jing1", "欢": "huan1", "迎": "ying2",
    "早": "zao3", "晚": "wan3", "午": "wu3", "饭": "fan4", "茶": "cha2",
    "谢": "xie4", "请": "qing3", "您": "nin2", "贵": "gui4", "姓": "xing4",
    "零": "ling2", "二": "er4", "五": "wu3", "六": "liu4", "七": "qi1",
    "八": "ba1", "九": "jiu3", "百": "bai3", "千": "qian1", "亿": "yi4",
    "负": "fu4", "点": "dian3", "幺": "yao1", "整": "zheng3",
    "秒": "miao3", "号": "hao4", "星": "xing1", "气": "qi4", "温": "wen1",
    "摄": "she4", "氏": "shi4", "乘": "cheng2", "除": "chu2",
    "语": "yu3", "音": "yin1", "合": "he2", "速": "su4", "率": "lv4",
    "波": "bo1", "频": "pin2", "今": "jin1", "天": "tian1", "质": "zhi4",
}


class _BuiltinG2P:
    """Word-table-first offline G2P: polyphonic characters resolve by
    word context (``WORD_PINYIN`` longest-match), then per-character
    lookup over the merged char tables (`_pinyin_data.py`)."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        from ._pinyin_data import CHAR_PINYIN_EXTRA, WORD_PINYIN
        self.words = WORD_PINYIN
        self.chars = dict(_BUILTIN_PINYIN)
        self.chars.update(CHAR_PINYIN_EXTRA)
        self.max_word = max((len(k) for k in self.words), default=1)

    def __call__(self, word: str) -> List[str]:
        out: List[str] = []
        i = 0
        while i < len(word):
            matched = False
            for ln in range(min(self.max_word, len(word) - i), 1, -1):
                chunk = word[i:i + ln]
                if chunk in self.words:
                    out.extend(self.words[chunk].split())
                    i += ln
                    matched = True
                    break
            if matched:
                continue
            ch = word[i]
            if ch in self.chars:
                out.append(self.chars[ch])
            elif self.strict:
                raise KeyError(
                    f"character {ch!r} not in the built-in pinyin table; "
                    "install pypinyin or pass pinyin_lexicon_path")
            i += 1
        return out


class _LexiconZhG2P:
    """word/char -> pinyin lexicon file, longest-match-first."""

    def __init__(self, path: str, fallback=None):
        self.table: Dict[str, List[str]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.table[parts[0]] = parts[1:]
        self.fallback = fallback or _BuiltinG2P(strict=False)
        self.max_len = max((len(k) for k in self.table), default=1)

    def __call__(self, word: str) -> List[str]:
        if word in self.table:
            return list(self.table[word])
        out: List[str] = []
        i = 0
        while i < len(word):
            for ln in range(min(self.max_len, len(word) - i), 0, -1):
                if word[i:i + ln] in self.table:
                    out.extend(self.table[word[i:i + ln]])
                    i += ln
                    break
            else:
                out.extend(self.fallback(word[i]))
                i += 1
        return out


class _PypinyinG2P:
    def __init__(self):
        from pypinyin import lazy_pinyin, Style  # noqa: F401
        self._lazy = lazy_pinyin
        self._style = Style.TONE3

    def __call__(self, word: str) -> List[str]:
        sylls = self._lazy(word, style=self._style, neutral_tone_with_five=True)
        return [s if s[-1].isdigit() else s + "5" for s in sylls]


class Frontend:
    """get_input_ids(sentence) -> {"phone_ids": [...], "tone_ids": [...]}
    (reference zh_frontend.py:228)."""

    def __init__(self, phone_vocab_path: Optional[str] = None,
                 tone_vocab_path: Optional[str] = None,
                 pinyin_lexicon_path: Optional[str] = None,
                 strict: bool = True):
        self.text_normalizer = TextNormalizer()
        try:
            self.g2p = _PypinyinG2P()
        except Exception:
            if pinyin_lexicon_path and os.path.exists(pinyin_lexicon_path):
                self.g2p = _LexiconZhG2P(pinyin_lexicon_path)
            else:
                self.g2p = _BuiltinG2P(strict=strict)
        # inject the live G2P so ToneSandhi's consecutive-third-tone merge
        # passes can see per-word tones (reference tone_sandhi.py:255-262
        # uses pypinyin directly there)
        self.tone_sandhi = ToneSandhi(finals_fn=self.g2p)
        self.phone_vocab = self._load_vocab(phone_vocab_path)
        self.tone_vocab = self._load_vocab(tone_vocab_path)

    @staticmethod
    def _load_vocab(path: Optional[str]) -> Optional[Dict[str, int]]:
        if path is None or not os.path.exists(path):
            return None
        table: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    table[parts[0]] = int(parts[1])
        return table

    # erhua merge word lists (reference zh_frontend.py:44-58)
    MUST_ERHUA = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿", "妥妥儿"}
    NOT_ERHUA = {
        "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿", "俺儿",
        "妻儿", "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿", "婴幼儿",
        "连体儿", "脑瘫儿", "流浪儿", "体弱儿", "混血儿", "蜜雪儿", "舫儿", "祖儿",
        "美儿", "应采儿", "可儿", "侄儿", "孙儿", "侄孙儿", "女儿", "男儿", "红孩儿",
        "花儿", "虫儿", "马儿", "鸟儿", "猪儿", "猫儿", "狗儿",
    }

    def _merge_erhua(self, sylls: List[str], word: str,
                     pos: str) -> List[str]:
        """Fold a trailing 儿 (er2/er5) into the previous syllable as an
        'r' suffix, honoring the must/not word lists and POS filter
        (reference zh_frontend.py:144-163)."""
        if word not in self.MUST_ERHUA and (
                word in self.NOT_ERHUA or pos in {"a", "j", "nr"}):
            return sylls
        if (len(sylls) >= 2 and len(word) >= 2 and word[-1] == "儿"
                and sylls[-1] in ("er2", "er5")
                and word[-2:] not in self.NOT_ERHUA):
            prev = sylls[-2]
            if prev and prev[-1].isdigit():
                prev = prev[:-1] + "r" + prev[-1]
            else:
                prev = prev + "r"
            return sylls[:-2] + [prev]
        return sylls

    # ---- pipeline steps -------------------------------------------------
    def _g2p_sentence(self, sentence: str,
                      with_sandhi: bool = True,
                      with_erhua: bool = True) -> List[str]:
        """Normalized sentence -> toned pinyin syllables."""
        if _HAS_JIEBA:
            seg = [(w.word, w.flag) for w in psg.cut(sentence)]
        else:
            seg = [(sentence, "n")]
        if with_sandhi:
            seg = self.tone_sandhi.pre_merge_for_modify(seg)
        # re-join polyphone contexts jieba splits apart (长|得很高: the
        # bare 长 would fall to the char table as chang2 — residual
        # class 2 in docs/frontend_accuracy.md, closed round 4)
        merged: List[tuple] = []
        for word, pos in seg:
            if merged and (merged[-1][0] + word) in _SPLIT_POLYPHONE_WORDS:
                merged[-1] = (merged[-1][0] + word, merged[-1][1])
            else:
                merged.append((word, pos))
        seg = merged
        word_sylls: List[tuple] = []
        for word, pos in seg:
            if not _CHINESE.search(word):
                # punctuation/latin: emits nothing but marks a pause
                # boundary that blocks cross-word sandhi
                word_sylls.append((None, pos))
                continue
            if len(word) == 1 and (word, pos[:1]) in _POS_CHAR_PINYIN:
                py = [_POS_CHAR_PINYIN[(word, pos[:1])]]
            else:
                py = self.g2p(word)
                # adverbial -地 (轻轻地, pos d/z) reads the particle de5,
                # not the char-table di4 — same readjustment pypinyin
                # does through its word dict
                if (len(word) > 1 and word[-1] == "地"
                        and pos in ("d", "z", "ad") and len(py) == len(word)):
                    py[-1] = "de5"
            if with_sandhi and len(py) == len(word):
                finals = [s for s in py]
                finals = self.tone_sandhi.modified_tone(word, pos, finals)
                py = finals
            if with_erhua and len(py) == len(word):
                py = self._merge_erhua(py, word, pos)
            word_sylls.append((py, pos))
        if with_sandhi:
            _cross_word_three_sandhi(word_sylls)
        return [s for py, _ in word_sylls if py for s in py]

    def get_syllables(self, sentence: str,
                      with_erhua: bool = True) -> List[str]:
        """Raw text -> flat list of toned pinyin syllables (erhua folded,
        sandhi applied).  The unit the G2P accuracy harness scores."""
        sylls: List[str] = []
        for s in self.text_normalizer.normalize(sentence):
            sylls.extend(self._g2p_sentence(s, with_erhua=with_erhua))
        return sylls

    def get_phonemes(self, sentence: str,
                     with_erhua: bool = True) -> List[List[str]]:
        """Raw text -> list (per normalized sub-sentence) of phone lists."""
        sentences = self.text_normalizer.normalize(sentence)
        out = []
        for s in sentences:
            phones: List[str] = []
            for syll in self._g2p_sentence(s, with_erhua=with_erhua):
                try:
                    phones.extend(syllable_to_phones(syll))
                except ValueError:
                    continue
            if phones:
                out.append(phones)
        return out

    def get_input_ids(self, sentence: str, merge_sentences: bool = True):
        """Text -> {"phone_ids": [...]} (+tone_ids with a tone vocab)."""
        phoneme_lists = self.get_phonemes(sentence)
        if merge_sentences:
            merged: List[str] = []
            for ph in phoneme_lists:
                merged.extend(ph + ["sp"])
            phoneme_lists = [merged[:-1]] if merged else []
        result = {"phones": phoneme_lists}
        if self.phone_vocab is not None:
            if self.tone_vocab is not None:
                phone_ids, tone_ids = [], []
                for ph in phoneme_lists:
                    pids, tids = [], []
                    for p in ph:
                        base, tone = self._split_tone(p)
                        if base in self.phone_vocab:
                            pids.append(self.phone_vocab[base])
                            tids.append(self.tone_vocab.get(tone, 0))
                    phone_ids.append(pids)
                    tone_ids.append(tids)
                result["phone_ids"] = phone_ids
                result["tone_ids"] = tone_ids
            else:
                result["phone_ids"] = [
                    [self.phone_vocab[p] for p in ph
                     if p in self.phone_vocab]
                    for ph in phoneme_lists]
        return result

    @staticmethod
    def _split_tone(phone: str):
        if phone and phone[-1].isdigit():
            return phone[:-1], phone[-1]
        return phone, "0"
