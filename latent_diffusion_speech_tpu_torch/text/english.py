"""English text frontend: CMUdict G2P.

Parity surface with the reference (`text/english.py`): CMU dictionary lookup
(`cmudict.rep`, the reference's own data file format with ` - `-separated
syllables starting at line 49), ARPA -> lower-case symbol + tone extraction
(tone = trailing stress digit + 1), g2p_en fallback for OOV words when the
package is available, else letter-wise dictionary spelling.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Tuple

from latent_diffusion_speech_tpu_torch.text.data_files import find_data_file
from latent_diffusion_speech_tpu_torch.text.symbols import symbols

ARPA = {
    "AH0", "S", "AH1", "EY2", "AE2", "EH0", "OW2", "UH0", "NG", "B", "G", "AY0",
    "M", "AA0", "F", "AO0", "ER2", "UH1", "IY1", "AH2", "DH", "IY0", "EY1",
    "IH0", "K", "N", "W", "IY2", "T", "AA1", "ER1", "EH2", "OY0", "UH2", "UW1",
    "Z", "AW2", "AW1", "V", "UW2", "AA2", "ER", "AW0", "UW0", "R", "OW1", "EH1",
    "ZH", "AE0", "IH2", "IH", "Y", "JH", "P", "AY1", "EY0", "OY2", "TH", "HH",
    "D", "ER0", "CH", "AO1", "AE1", "AO2", "OY1", "AY2", "IH1", "OW0", "L", "SH",
}

_POST_REP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?", "\n": ".",
    "·": ",", "、": ",", "...": "…", "v": "V",
}


def post_replace_ph(ph: str) -> str:
    ph = _POST_REP.get(ph, ph)
    return ph if ph in symbols else "UNK"


@lru_cache(maxsize=1)
def cmu_dict() -> dict:
    path = find_data_file("cmudict.rep")
    if path is None:
        return {}
    out = {}
    with open(path) as fh:
        for line_index, line in enumerate(fh, start=1):
            if line_index < 49:
                continue
            line = line.strip()
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = parts[0]
            out[word] = [syl.split(" ") for syl in parts[1].split(" - ")]
    return out


def refine_ph(phn: str) -> Tuple[str, int]:
    tone = 0
    if re.search(r"\d$", phn):
        tone = int(phn[-1]) + 1
        phn = phn[:-1]
    return phn.lower(), tone


def refine_syllables(syllables) -> Tuple[List[str], List[int]]:
    phonemes, tones = [], []
    for syl in syllables:
        for phn in syl:
            p, t = refine_ph(phn)
            phonemes.append(p)
            tones.append(t)
    return phonemes, tones


@lru_cache(maxsize=1)
def _g2p_en():
    try:
        from g2p_en import G2p

        return G2p()
    except ImportError:
        return None


def _flat_lookup(word: str):
    """CMUdict lookup returning a flat stress-digit phone list, or None."""
    syllables = cmu_dict().get(word.upper())
    if syllables is None:
        return None
    return [ph for syl in syllables for ph in syl]


def _oov_to_phones(word: str) -> Tuple[List[str], List[int]]:
    """OOV fallback chain: g2p_en when the package exists (reference parity,
    the reference's `text/english.py:13,49`), else the native morphological
    stem lookup, else NRL-style letter-to-sound rules."""
    g2p_model = _g2p_en()
    if g2p_model is not None:
        phones, tones = [], []
        for ph in (p for p in g2p_model(word) if p != " "):
            if ph in ARPA:
                p, t = refine_ph(ph)
                phones.append(p)
                tones.append(t)
            else:
                phones.append(ph)
                tones.append(0)
        return phones, tones

    from latent_diffusion_speech_tpu_torch.text.letter_to_sound import lts, stem_lookup

    arpa = stem_lookup(word, _flat_lookup) or lts(word)
    phones, tones = [], []
    for ph in arpa:
        p, t = refine_ph(ph)
        phones.append(p)
        tones.append(t)
    return phones, tones


# ---------------------------------------------------------------------------
# number verbalization (the reference's text_normalize is a literal no-op
# `todo` — the reference's `text/english.py:99-101` — so digits fell through
# to OOV G2P; verbalizing them is a strict improvement, mirroring what the
# ZH frontend does with its native cn2an-equivalent)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
           (10**3, "thousand"), (100, "hundred")]


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rest] if rest else "")
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = _int_to_words(head) + " " + name
            return out + (" " + _int_to_words(rest) if rest else "")
    return _ONES[0]  # unreachable


def _num_to_words(token: str) -> str:
    """'123' / '-4.25' / '30%' / '1,000' -> spoken English."""
    token = token.replace(",", "")
    percent = token.endswith("%")
    if percent:
        token = token[:-1]
    if "." in token:
        whole, frac = token.split(".", 1)
        words = _int_to_words(int(whole or 0)) + " point " + " ".join(
            _ONES[int(d)] for d in frac if d.isdigit()
        )
    else:
        words = _int_to_words(int(token))
    return words + (" percent" if percent else "")


# no leading minus: "2020-2021"-style ranges must not verbalize as "minus"
_NUM_RE = re.compile(r"\d[\d,]*(?:\.\d+)?%?")


def text_normalize(text: str) -> str:
    """Verbalize numbers (incl. decimals, thousands separators, percent);
    otherwise pass text through like the reference."""
    return _NUM_RE.sub(lambda m: " " + _num_to_words(m.group(0)) + " ", text)


def g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    d = cmu_dict()
    phones: List[str] = []
    tones: List[int] = []
    for w in re.split(r"([,;.\-\?\!\s+])", text):
        if not w or w.isspace():
            continue
        if w.upper() in d:
            p, t = refine_syllables(d[w.upper()])
        else:
            p, t = _oov_to_phones(w)
        phones += p
        tones += t
    phones = [post_replace_ph(p) for p in phones]
    word2ph = [1] * len(phones)
    return phones, tones, word2ph
