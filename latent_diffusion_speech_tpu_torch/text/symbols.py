"""Phoneme symbol table shared by the text frontend and the semantic LM.

This is a *data contract* with the reference (`text/symbols.py:1-47`): the
merged ZH+JA+EN phoneme inventory, tone counts, and language maps must be
value-identical or token ids diverge.  Layout: pad '_' at id 0, then the
sorted union of per-language phonemes, then punctuation + SP/UNK.
"""

from __future__ import annotations

PUNCTUATION = ["!", "?", "…", ",", ".", "'", "-"]
PU_SYMBOLS = PUNCTUATION + ["SP", "UNK"]
PAD = "_"

# Mandarin initials/finals (opencpop-strict inventory + AA/EE/OO extensions)
ZH_SYMBOLS = [
    "E", "En", "a", "ai", "an", "ang", "ao", "b", "c", "ch", "d", "e", "ei",
    "en", "eng", "er", "f", "g", "h", "i", "i0", "ia", "ian", "iang", "iao",
    "ie", "in", "ing", "iong", "ir", "iu", "j", "k", "l", "m", "n", "o",
    "ong", "ou", "p", "q", "r", "s", "sh", "t", "u", "ua", "uai", "uan",
    "uang", "ui", "un", "uo", "v", "van", "ve", "vn", "w", "x", "y", "z",
    "zh", "AA", "EE", "OO",
]
NUM_ZH_TONES = 6

# Japanese (pyopenjtalk romaji inventory)
JA_SYMBOLS = [
    "I", "N", "U", "a", "b", "by", "ch", "cl", "d", "dy", "e", "f", "g", "gy",
    "h", "hy", "i", "j", "k", "ky", "m", "my", "n", "ny", "o", "p", "py", "r",
    "ry", "s", "sh", "t", "ts", "u", "V", "w", "y", "z",
]
NUM_JA_TONES = 1

# English (lower-cased ARPAbet)
EN_SYMBOLS = [
    "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d", "dh", "eh", "er",
    "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l", "m", "n", "ng", "ow",
    "oy", "p", "r", "s", "sh", "t", "th", "uh", "uw", "V", "w", "y", "z", "zh",
]
NUM_EN_TONES = 4

normal_symbols = sorted(set(ZH_SYMBOLS + JA_SYMBOLS + EN_SYMBOLS))
symbols = [PAD] + normal_symbols + PU_SYMBOLS
sil_phonemes_ids = [symbols.index(s) for s in PU_SYMBOLS]
pad_id = 0

num_tones = NUM_ZH_TONES + NUM_JA_TONES + NUM_EN_TONES

language_id_map = {"ZH": 0, "JA": 1, "EN": 2}
num_languages = len(language_id_map)

language_tone_start_map = {
    "ZH": 0,
    "JA": NUM_ZH_TONES,
    "EN": NUM_ZH_TONES + NUM_JA_TONES,
}

# compat aliases matching the reference module's names
punctuation = PUNCTUATION
pu_symbols = PU_SYMBOLS
pad = PAD
zh_symbols = ZH_SYMBOLS
ja_symbols = JA_SYMBOLS
en_symbols = EN_SYMBOLS
num_zh_tones = NUM_ZH_TONES
num_ja_tones = NUM_JA_TONES
num_en_tones = NUM_EN_TONES
