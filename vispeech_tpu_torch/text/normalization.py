"""Chinese non-standard-word (NSW) text normalization.

Verbalizes numbers, dates, times, temperatures, fractions, percentages,
phone numbers and ranges into hanzi, then splits into sentences — the same
behavioral contract as the reference's PaddleSpeech-derived cascade
(reference: text/frontend/zh_normalization/, 7 files; rule order follows
text_normlization.py:79-110).  Re-implemented from the verbalization rules of
modern written Chinese (zh.wikipedia.org/wiki/中文数字).

Everything here is host-side pure Python with no third-party dependencies,
including traditional→simplified conversion (built-in table, text/t2s_data.py).

The port's copy of ``vispeech_tpu/text/normalization.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
import string
from typing import List, Match

# ---------------------------------------------------------------------------
# Cardinal / digit verbalization
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
# place-value units by power of ten: 10^1 十, 10^2 百, 10^3 千, 10^4 万, 10^8 亿
_UNIT_POWERS = (8, 4, 3, 2, 1)
_UNIT_NAMES = {1: "十", 2: "百", 3: "千", 4: "万", 8: "亿"}


def _cardinal_symbols(digits: str, zero_prefix: bool = True) -> List[str]:
    """Recursive place-value expansion of an integer digit string."""
    stripped = digits.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        sym = [_DIGITS[int(stripped)]]
        # an interior zero run is voiced once: 105 → 一百零五
        if zero_prefix and len(stripped) < len(digits):
            return [_DIGITS[0]] + sym
        return sym
    power = next(p for p in _UNIT_POWERS if p < len(stripped))
    head, tail = digits[:-power], digits[-power:]
    return _cardinal_symbols(head) + [_UNIT_NAMES[power]] + _cardinal_symbols(tail)


def verbalize_cardinal(digits: str) -> str:
    """'1305' → 一千三百零五; '0'/'000' → 零; leading 一十 abbreviates to 十."""
    if not digits:
        return ""
    if not digits.lstrip("0"):
        return _DIGITS[0]
    syms = _cardinal_symbols(digits.lstrip("0"))
    if len(syms) >= 2 and syms[0] == _DIGITS[1] and syms[1] == _UNIT_NAMES[1]:
        syms = syms[1:]
    return "".join(syms)


def verbalize_digits(digits: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading; alt_one reads 1 as 幺 (phone numbers)."""
    out = "".join(_DIGITS[int(d)] for d in digits)
    return out.replace("一", "幺") if alt_one else out


def num2str(value: str) -> str:
    """Decimal string → hanzi ('3.20' → 三点二, '.22' → 零点二二)."""
    parts = value.split(".")
    if len(parts) > 2:
        raise ValueError(f"more than one decimal point in {value!r}")
    integer = parts[0]
    decimal = parts[1].rstrip("0") if len(parts) == 2 else ""
    result = verbalize_cardinal(integer)
    if decimal:
        result = (result or _DIGITS[0]) + "点" + verbalize_digits(decimal)
    return result


# ---------------------------------------------------------------------------
# NSW patterns (order matters; see normalize_sentence)
# ---------------------------------------------------------------------------

_QUANTIFIERS = (
    "(所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|"
    "砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|"
    "线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|"
    "(公)分|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|小时|"
    "旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块|元|"
    "(亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|美|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)"
)

RE_DATE = re.compile(
    r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?"
)
RE_DATE2 = re.compile(r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")
_TIME_CORE = r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
RE_TIME = re.compile(_TIME_CORE)
RE_TIME_RANGE = re.compile(_TIME_CORE + r"(~|-)" + _TIME_CORE)
RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")
RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")
RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)"
)
RE_TELEPHONE = re.compile(r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{7,8})(?!\d)")
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")
RE_RANGE = re.compile(
    r"((-?)((\d+)(\.\d+)?)|(\.(\d+)))[-~]((-?)((\d+)(\.\d+)?)|(\.(\d+)))"
)
RE_INTEGER = re.compile(r"(-)(\d+)")
RE_DECIMAL_NUM = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
RE_POSITIVE_QUANTIFIERS = re.compile(r"(\d+)([多余几\+])?" + _QUANTIFIERS)
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")


def _time_digits(num: str) -> str:
    """Minutes/seconds keep a voiced leading zero: 05 → 零五."""
    out = num2str(num.lstrip("0") or "0")
    if num.startswith("0") and num.lstrip("0"):
        out = _DIGITS[0] + out
    return out


def _verbalize_hms(hour: str, minute: str, second: str | None) -> str:
    out = f"{num2str(hour)}点"
    if minute.lstrip("0"):
        out += "半" if int(minute) == 30 else f"{_time_digits(minute)}分"
    if second and second.lstrip("0"):
        out += f"{_time_digits(second)}秒"
    return out


def _sub_time(m: Match) -> str:
    groups = m.groups()
    out = _verbalize_hms(groups[0], groups[1], groups[3])
    if len(groups) > 5:  # range form
        out += "至" + _verbalize_hms(groups[5], groups[6], groups[8])
    return out


def _sub_date(m: Match) -> str:
    out = ""
    if m.group(1):
        out += f"{verbalize_digits(m.group(1))}年"
    if m.group(3):
        out += f"{verbalize_cardinal(m.group(3))}月"
    if m.group(5):
        out += f"{verbalize_cardinal(m.group(5))}{m.group(9)}"
    return out


def _sub_date2(m: Match) -> str:
    return (
        f"{verbalize_digits(m.group(1))}年"
        f"{verbalize_cardinal(m.group(3))}月"
        f"{verbalize_cardinal(m.group(4))}日"
    )


def _sub_temperature(m: Match) -> str:
    sign = "零下" if m.group(1) else ""
    unit = "摄氏度" if m.group(4) == "摄氏度" else "度"
    return f"{sign}{num2str(m.group(2))}{unit}"


def _sub_frac(m: Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(3))}分之{num2str(m.group(2))}"


def _sub_percentage(m: Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}百分之{num2str(m.group(2))}"


def _sub_mobile(m: Match) -> str:
    parts = m.group(0).strip("+").split()
    return "，".join(verbalize_digits(p, alt_one=True) for p in parts)


def _sub_phone(m: Match) -> str:
    parts = m.group(0).split("-")
    return "，".join(verbalize_digits(p, alt_one=True) for p in parts)


def _sub_number(m: Match) -> str:
    if m.group(5):  # pure decimal like .22
        return num2str(m.group(5))
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(2))}"


def _sub_range(m: Match) -> str:
    first = RE_NUMBER.sub(_sub_number, m.group(1))
    second = RE_NUMBER.sub(_sub_number, m.group(8))
    return f"{first}到{second}"


def _sub_negative(m: Match) -> str:
    return f"负{num2str(m.group(2))}"


def _sub_quantifier(m: Match) -> str:
    approx = m.group(2) or ""
    if approx == "+":
        approx = "多"
    return f"{num2str(m.group(1))}{approx}{m.group(3)}"


def _sub_digit_seq(m: Match) -> str:
    return verbalize_digits(m.group(0))


# Full-width → half-width translation tables.
_F2H_LETTERS = {ord(chr(ord(c) + 65248)): c for c in string.ascii_letters}
_F2H_DIGITS = {ord(chr(ord(c) + 65248)): c for c in string.digits}
_F2H_SPACE = {0x3000: " "}


def _traditional_to_simplified(text: str) -> str:
    """Self-contained per-character conversion (reference ships its own table,
    char_convert.py:30 — no optional dependency, no silent identity)."""
    from vispeech_tpu_torch.text.t2s_data import T2S

    return "".join(T2S.get(ch, ch) for ch in text)


class TextNormalizer:
    """Sentence splitting + NSW verbalization (reference text_normlization.py:53-116)."""

    SENTENCE_SPLITTER = re.compile(r"([：、，；。？！,;?!….][”’]?)")
    _STRIP_CHARS = re.compile(r"[《》【】<=>{}()（）&@“”^_|\\]")

    def split(self, text: str, lang: str = "zh") -> List[str]:
        if lang == "zh":
            text = text.replace(" ", "")
            text = self._STRIP_CHARS.sub("", text)
        text = self.SENTENCE_SPLITTER.sub(r"\1\n", text).strip()
        return [s.strip() for s in re.split(r"\n+", text)]

    def normalize_sentence(self, sentence: str) -> str:
        sentence = _traditional_to_simplified(sentence)
        sentence = (
            sentence.translate(_F2H_LETTERS).translate(_F2H_DIGITS).translate(_F2H_SPACE)
        )
        sentence = RE_DATE.sub(_sub_date, sentence)
        sentence = RE_DATE2.sub(_sub_date2, sentence)
        sentence = RE_TIME_RANGE.sub(_sub_time, sentence)
        sentence = RE_TIME.sub(_sub_time, sentence)
        sentence = RE_TEMPERATURE.sub(_sub_temperature, sentence)
        sentence = RE_FRAC.sub(_sub_frac, sentence)
        sentence = RE_PERCENTAGE.sub(_sub_percentage, sentence)
        sentence = RE_MOBILE_PHONE.sub(_sub_mobile, sentence)
        sentence = RE_TELEPHONE.sub(_sub_phone, sentence)
        sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(_sub_phone, sentence)
        sentence = RE_RANGE.sub(_sub_range, sentence)
        sentence = RE_INTEGER.sub(_sub_negative, sentence)
        sentence = RE_DECIMAL_NUM.sub(_sub_number, sentence)
        sentence = RE_POSITIVE_QUANTIFIERS.sub(_sub_quantifier, sentence)
        sentence = RE_DEFAULT_NUM.sub(_sub_digit_seq, sentence)
        sentence = RE_NUMBER.sub(_sub_number, sentence)
        sentence = sentence.replace("/", "每").replace("~", "至")
        return sentence

    def normalize(self, text: str) -> List[str]:
        return [self.normalize_sentence(s) for s in self.split(text)]
