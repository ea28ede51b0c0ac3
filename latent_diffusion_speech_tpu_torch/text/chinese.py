"""Chinese text frontend: normalization + G2P.

Parity surface with the reference (`text/chinese.py:57-146`): cn2an-style
number verbalization, punctuation folding, jieba POS segmentation + pypinyin
initials/finals, tone sandhi, and the opencpop-strict pinyin->phoneme mapping
(including the uei/iou/uen and standalone-syllable rewrite rules).

Dependency posture: jieba is required only for hanzi input; pypinyin likewise.
Without pypinyin the module still supports *tone-annotated pinyin input*
("ni3 hao3") through `g2p_pinyin`, using a native syllable splitter —
so the ZH pipeline stays usable in minimal environments.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Tuple

from latent_diffusion_speech_tpu_torch.text.data_files import find_data_file
from latent_diffusion_speech_tpu_torch.text.symbols import punctuation
from latent_diffusion_speech_tpu_torch.text.tone_sandhi import ToneSandhi

REP_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?", "\n": ".",
    "·": ",", "、": ",", "...": "…", "$": ".", "“": "'", "”": "'", "‘": "'",
    "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'", "》": "'",
    "【": "'", "】": "'", "[": "'", "]": "'", "—": "-", "～": "-", "~": "-",
    "「": "'", "」": "'",
}

# rewrite rules from the reference g2p (chinese.py:104-135)
V_REP_MAP = {"uei": "ui", "iou": "iu", "uen": "un"}
PINYIN_REP_MAP = {"ing": "ying", "i": "yi", "in": "yin", "u": "wu"}
SINGLE_REP_MAP = {"v": "yu", "e": "e", "i": "y", "u": "w"}

_tone_sandhi = ToneSandhi()


@lru_cache(maxsize=1)
def pinyin_to_symbol_map() -> dict:
    path = find_data_file("opencpop-strict.txt")
    if path is None:
        raise FileNotFoundError(
            "opencpop-strict.txt not found; set LDS_TEXT_DATA_DIR to a directory containing it"
        )
    out = {}
    for line in path.read_text().splitlines():
        if "\t" in line:
            key, val = line.strip().split("\t")
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# number verbalization (cn2an.an2cn equivalent for the digits-only case)
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_GROUP_UNITS = ["", "万", "亿", "万亿"]


def _int_to_hanzi(n: int) -> str:
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if parts and not parts[-1].endswith("零"):
                parts.append("零")
            continue
        s = ""
        digits = f"{g:04d}" if gi < len(groups) - 1 else str(g)
        lead_zero = gi < len(groups) - 1 and digits[0] == "0"
        digits = digits.lstrip("0")
        prev_zero = False
        for i, d in enumerate(digits):
            place = len(digits) - i - 1
            if d == "0":
                prev_zero = True
                continue
            if prev_zero:
                s += "零"
                prev_zero = False
            s += _DIGITS[int(d)] + _UNITS[place]
        if lead_zero:
            s = "零" + s
        parts.append(s + _GROUP_UNITS[gi])
    out = "".join(parts)
    # 一十X -> 十X at the very front (cn2an convention: 10 -> 十, 110 -> 一百一十)
    if out.startswith("一十"):
        out = out[1:]
    return out


def an2cn(number: str) -> str:
    """Arabic numeral string -> hanzi (integers + decimals)."""
    if "." in number:
        int_part, frac = number.split(".", 1)
        frac_h = "".join(_DIGITS[int(d)] for d in frac)
        return _int_to_hanzi(int(int_part or "0")) + "点" + frac_h
    return _int_to_hanzi(int(number))


def text_normalize(text: str) -> str:
    """Numbers -> hanzi, punctuation folded, non-hanzi stripped (ref :57-64,147-152).

    Extends the reference's cn2an integer/decimal handling with percent
    (123.5% -> 百分之...), fraction (3/4 -> 四分之三) and negative (-5 -> 负五)
    forms, which the reference's bare `\\d+(\\.?\\d+)?` regex verbalizes
    incorrectly (the %, / and - would be silently dropped)."""
    # percent: N% -> 百分之N
    text = re.sub(
        r"(\d+(?:\.\d+)?)\s*[%％]",
        lambda m: "百分之" + an2cn(m.group(1)),
        text,
    )
    # fraction: A/B -> B分之A
    text = re.sub(
        r"(\d+)\s*/\s*(\d+)",
        lambda m: an2cn(m.group(2)) + "分之" + an2cn(m.group(1)),
        text,
    )
    # negative numbers: -N -> 负N (only when clearly a sign, not a range dash)
    text = re.sub(
        r"(?<!\d)[-−](\d+(?:\.\d+)?)",
        lambda m: "负" + an2cn(m.group(1)),
        text,
    )
    for number in re.findall(r"\d+(?:\.?\d+)?", text):
        text = text.replace(number, an2cn(number), 1)
    text = text.replace("嗯", "恩").replace("呣", "母")
    pattern = re.compile("|".join(re.escape(p) for p in REP_MAP))
    text = pattern.sub(lambda m: REP_MAP[m.group()], text)
    text = re.sub(r"[^一-龥" + "".join(punctuation) + r"]+", "", text)
    return text


# ---------------------------------------------------------------------------
# pinyin syllable -> phones
# ---------------------------------------------------------------------------

def _pinyin_to_phones(initial: str, final_with_tone: str) -> Tuple[List[str], str]:
    """(initial, final+tone) -> (phonemes, tone). Applies the reference's
    rewrite rules before the opencpop lookup (ref :98-137)."""
    if initial == final_with_tone:  # punctuation
        return [initial], "0"
    v_without_tone = final_with_tone[:-1]
    tone = final_with_tone[-1]
    assert tone in "12345", (initial, final_with_tone)
    pinyin = initial + v_without_tone
    if initial:
        if v_without_tone in V_REP_MAP:
            pinyin = initial + V_REP_MAP[v_without_tone]
    else:
        if pinyin in PINYIN_REP_MAP:
            pinyin = PINYIN_REP_MAP[pinyin]
        elif pinyin and pinyin[0] in SINGLE_REP_MAP:
            pinyin = SINGLE_REP_MAP[pinyin[0]] + pinyin[1:]
    mapping = pinyin_to_symbol_map()
    if pinyin not in mapping:
        raise KeyError(f"pinyin {pinyin!r} not in opencpop map")
    return mapping[pinyin].split(" "), tone


_INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
]


def split_pinyin(syllable: str) -> Tuple[str, str]:
    """'zhong1' -> ('zh', 'ong1'). Native splitter for annotated-pinyin input.
    y/w are treated as part of the final (pypinyin INITIALS style strips them)."""
    for ini in _INITIALS:
        if ini in ("y", "w"):
            continue
        if syllable.startswith(ini):
            return ini, syllable[len(ini):]
    return "", syllable


def g2p_pinyin(pinyin_text: str) -> Tuple[List[str], List[int], List[int]]:
    """G2P for tone-annotated pinyin input ('ni3 hao3 , shi4 jie4').
    Needs no pypinyin/jieba. Returns (phones, tones, word2ph)."""
    phones, tones, word2ph = [], [], []
    for token in pinyin_text.split():
        if token in punctuation:
            phones.append(token)
            tones.append(0)
            word2ph.append(1)
            continue
        if not token[-1].isdigit():
            token = token + "5"
        ini, fin = split_pinyin(token)
        # feed through the same rewrite rules; standalone finals go in raw
        if ini in ("y", "w"):
            ini = ""
            fin = token
        ph, tone = _pinyin_to_phones(ini, fin)
        phones += ph
        tones += [int(tone)] * len(ph)
        word2ph.append(len(ph))
    return phones, tones, word2ph


# ---------------------------------------------------------------------------
# hanzi G2P (requires jieba + pypinyin)
# ---------------------------------------------------------------------------

def _merge_table_words(seg_cut):
    """Re-join adjacent posseg segments whose concatenation is a curated
    polyphone word entry (e.g. posseg yields 好|觉 but the table knows
    好觉 = hao3 jiao4). Pairwise longest-first, left to right."""
    from latent_diffusion_speech_tpu_torch.text.pinyin import is_word_entry

    seg_cut = [(w, p) for w, p in seg_cut]  # jieba pair objects -> tuples
    out = []
    i = 0
    while i < len(seg_cut):
        if i + 1 < len(seg_cut):
            joined = seg_cut[i][0] + seg_cut[i + 1][0]
            if len(joined) <= 4 and is_word_entry(joined):
                out.append((joined, seg_cut[i + 1][1]))
                i += 2
                continue
        out.append(seg_cut[i])
        i += 1
    return out


def _get_initials_finals(word: str):
    from latent_diffusion_speech_tpu_torch.text.pinyin import is_word_entry

    if is_word_entry(word):
        # curated word-level reading beats pypinyin's generic phrase dict
        from latent_diffusion_speech_tpu_torch.text.pinyin import to_initials_finals

        return to_initials_finals(word)
    try:
        from pypinyin import Style, lazy_pinyin

        initials = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.INITIALS)
        finals = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.FINALS_TONE3)
        return initials, finals
    except ImportError:
        # vendored reading table (same conventions); see text/pinyin.py
        from latent_diffusion_speech_tpu_torch.text.pinyin import to_initials_finals

        return to_initials_finals(word)


def g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    """Hanzi G2P with tone sandhi (ref :66-145). Readings come from pypinyin
    when installed, else from the vendored table (`text/pinyin.py`)."""
    try:
        import jieba.posseg as psg
    except ImportError as e:
        raise ImportError("hanzi G2P needs jieba; use g2p_pinyin for annotated input") from e

    pattern = r"(?<=[{0}])\s*".format("".join(punctuation))
    sentences = [s for s in re.split(pattern, text) if s.strip()]

    phones_list: List[str] = []
    tones_list: List[int] = []
    word2ph: List[int] = []
    for seg in sentences:
        seg = re.sub("[a-zA-Z]+", "", seg)
        seg_cut = _merge_table_words(psg.lcut(seg))
        seg_cut = _tone_sandhi.pre_merge_for_modify(seg_cut)
        initials, finals = [], []
        for word, pos in seg_cut:
            if pos == "eng":
                continue
            sub_i, sub_f = _get_initials_finals(word)
            sub_f = _tone_sandhi.modified_tone(word, pos, sub_f)
            # NOTE: standalone locatives split off by posseg (公园|里) keep
            # their full tone — matches pypinyin/PaddleSpeech behavior; a
            # neutralize-here variant was measured WORSE on the held-out set
            initials += sub_i
            finals += sub_f
        for c, v in zip(initials, finals):
            ph, tone = _pinyin_to_phones(c, v) if c != v else ([c], "0")
            phones_list += ph
            tones_list += [int(tone)] * len(ph)
            word2ph.append(len(ph))
    return phones_list, tones_list, word2ph
