"""Native hanzi -> tone-annotated pinyin lookup (pypinyin replacement).

The reference obtains per-character readings through pypinyin
(the reference's `text/chinese.py:66-78`); that package is not available in
minimal environments, so the framework vendors a compact reading table
(`data/pinyin_table.txt`) covering the common-use character set plus word
entries for polyphones, and converts full pinyin syllables to the
(initial, final_tone3) pair convention pypinyin's strict mode produces —
so the downstream opencpop rewrite rules (`chinese.py`) apply unchanged.

Table format, one entry per line, whitespace separated:
    <char> <pinyin><tone>              e.g.  中 zhong1
    <word> <pinyin><tone> <pinyin><tone> ...  e.g.  银行 yin2 hang2
Word entries override per-character defaults (polyphone disambiguation after
jieba segmentation, the same layer pypinyin's phrase dict provides).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

from latent_diffusion_speech_tpu_torch.text.data_files import find_data_file

__all__ = [
    "have_native_table",
    "is_word_entry",
    "word_to_pinyin",
    "to_initials_finals",
    "split_full_pinyin",
]


def is_word_entry(word: str) -> bool:
    """True when `word` has a curated word-level (polyphone) table entry."""
    return word in _tables()[1]

# pypinyin strict initials (y/w are not initials in strict mode)
_INITIALS_STRICT = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s",
]


@lru_cache(maxsize=1)
def _tables() -> Tuple[dict, dict]:
    """Returns (char_table, word_table)."""
    path = find_data_file("pinyin_table.txt")
    chars: dict = {}
    words: dict = {}
    if path is None:
        return chars, words
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key, readings = parts[0], parts[1:]
        if len(key) == 1:
            chars[key] = readings[0]
        else:
            words[key] = readings
    return chars, words


def have_native_table() -> bool:
    chars, _ = _tables()
    return len(chars) > 0


def word_to_pinyin(word: str) -> List[Optional[str]]:
    """Word -> full tone-annotated pinyin per character ('中国' -> ['zhong1',
    'guo2']). Word-level entries win (polyphones); characters without a
    reading yield None (callers skip them, mirroring pypinyin's errors=
    'ignore' posture for non-hanzi)."""
    chars, words = _tables()
    if word in words:
        return list(words[word])
    out: List[Optional[str]] = []
    i = 0
    n = len(word)
    while i < n:
        # longest-match word entries inside the segment (jieba words are
        # short; bounded 4-gram scan)
        matched = False
        for j in range(min(n, i + 4), i + 1, -1):
            sub = word[i:j]
            if sub in words:
                out.extend(words[sub])
                i = j
                matched = True
                break
        if not matched:
            out.append(chars.get(word[i]))
            i += 1
    return out


def split_full_pinyin(syllable: str) -> Tuple[str, str]:
    """Full pinyin -> pypinyin-strict (initial, final+tone).

    'zhong1' -> ('zh', 'ong1'); 'you3' -> ('', 'iou3'); 'ju2' -> ('j', 'v2');
    'wei4' -> ('', 'uei4'); 'ying1' -> ('', 'ing1').
    """
    tone = syllable[-1] if syllable[-1].isdigit() else "5"
    body = syllable[:-1] if syllable[-1].isdigit() else syllable
    body = body.replace("ü", "v").replace("u:", "v")
    for ini in _INITIALS_STRICT:
        if body.startswith(ini) and len(body) > len(ini):
            fin = body[len(ini):]
            # after j/q/x the written 'u' is the v (ü) final in strict mode
            if ini in ("j", "q", "x") and fin[0] == "u":
                fin = "v" + fin[1:]
            return ini, fin + tone
    if body.startswith("y"):
        rest = body[1:]
        if rest.startswith("u"):
            fin = "v" + rest[1:]          # yu yue yuan yun -> v ve van vn
        elif rest.startswith("i"):
            fin = rest                    # yi yin ying -> i in ing
        elif rest == "ou":
            fin = "iou"                   # you -> iou
        else:
            fin = "i" + rest              # ya ye yao yan yang yong yo
        return "", fin + tone
    if body.startswith("w"):
        rest = body[1:]
        fin = rest if rest.startswith("u") else "u" + rest  # wu->u, wei->uei
        return "", fin + tone
    return "", body + tone                # a o e ai er en ...


def to_initials_finals(word: str) -> Tuple[List[str], List[str]]:
    """pypinyin-equivalent (lazy_pinyin INITIALS, lazy_pinyin FINALS_TONE3
    with neutral_tone_with_five=True) from the vendored table. Non-hanzi
    characters (punctuation) are passed through as themselves — pypinyin's
    errors='default' posture, which downstream code detects via c == v.
    Hanzi without a table reading are dropped."""
    initials: List[str] = []
    finals: List[str] = []
    readings = word_to_pinyin(word)
    aligned = len(readings) == len(word)
    for i, syl in enumerate(readings):
        if syl is None:
            ch = word[i] if aligned else None
            if ch is not None and not ("一" <= ch <= "鿿"):
                initials.append(ch)
                finals.append(ch)
            continue
        ini, fin = split_full_pinyin(syl)
        initials.append(ini)
        finals.append(fin)
    return initials, finals


def finals_tone3(word: str) -> List[str]:
    """FINALS_TONE3-style list for the tone-sandhi merge heuristics."""
    return to_initials_finals(word)[1]
