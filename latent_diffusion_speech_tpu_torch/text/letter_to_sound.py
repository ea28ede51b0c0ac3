"""Rule-based English letter-to-sound (OOV fallback for the CMUdict G2P).

The reference resolves out-of-vocabulary words with the g2p_en neural model
(the reference's `text/english.py:13,49`), which is not installable here.
This module provides a dependency-free replacement with two tiers:

1. ``stem_lookup``: morphological suffix stripping (-s/-es/-ed/-ing/-ly/...)
   with standard voicing/epenthesis rules for the inflectional endings, so
   inflected forms of in-dictionary stems get dictionary-quality phones.
2. ``lts``: grapheme-to-phoneme translation rules in the style of the public
   domain NRL ruleset (Elovitz et al. 1976, "Letter-to-Sound Rules for
   Automatic Translation of English Text"), emitting ARPAbet. Stress is not
   modeled by the rules; the first vowel of a word is given primary stress.

Context pattern language (matched outward from the fragment):
  ``#`` one or more vowels        ``:`` zero or more consonants
  ``^`` exactly one consonant     ``.`` one voiced consonant (b d g j l m n r v w z)
  ``%`` one of the suffixes e/er/es/ed/ing/ely   ``&`` one sibilant
  ``@`` one of t/s/r/d/l/z/n/j/th/ch/sh          `` `` word boundary
Anything else matches literally.  Rules are tried top-down per fragment
letter-group; the first match consumes its fragment.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

_VOWELS = set("aeiouy")
_VOICED = set("bdgjlmnrvwz")
_SIBILANT_1 = set("scgzxj")
_SIBILANT_2 = ("ch", "sh")
_AT_1 = set("tsrdlznj")
_AT_2 = ("th", "ch", "sh")

# ---------------------------------------------------------------------------
# Rule table: (left context, fragment, right context, phones).
# Fragments are grouped by first letter; within a group order matters.
# Phones are space-separated ARPAbet without stress digits ("" = silent).
# ---------------------------------------------------------------------------

_R = [
    # punctuation-free words only reach us, so no symbol rules needed.
    ("", "aa", "", "AA"),     # haas/baal/aardvark: double-a is long AA
    (" ", "are", " ", "AA R"),
    (" ", "ar", "o", "AX R"),
    ("", "ar", "#", "EH R"),
    ("^", "as", "#", "EY S"),
    ("", "a", "gue", "EY"),   # vague, plague
    ("", "a", "wa", "AX"),
    ("", "aw", "", "AO"),
    (" :", "any", "", "EH N IY"),
    ("", "a", "^+#", "EY"),
    ("#:", "ally", "", "AX L IY"),
    (" ", "al", "#", "AX L"),
    ("", "again", "", "AX G EH N"),
    ("#:", "ag", "e", "IH JH"),
    ("", "a", "^+:#", "AE"),
    (" :", "a", "^+ ", "EY"),
    ("", "a", "^%", "EY"),
    (" ", "arr", "", "AX R"),
    ("", "arr", "", "AE R"),
    (" :", "ar", " ", "AA R"),
    ("", "ar", " ", "ER"),
    ("", "ar", "", "AA R"),
    ("", "air", "", "EH R"),
    ("", "ai", "", "EY"),
    ("", "ay", "", "EY"),
    ("", "au", "", "AO"),
    ("#:", "al", " ", "AX L"),
    ("#:", "als", " ", "AX L Z"),
    ("", "alk", "", "AO K"),
    ("", "al", "^", "AO L"),
    (" :", "able", "", "EY B AX L"),
    ("", "able", "", "AX B AX L"),
    ("", "ang", "+", "EY N JH"),
    ("", "a", "", "AE"),

    (" ", "be", "^#", "B IH"),
    ("b", "b", "", ""),
    ("", "being", "", "B IY IH NG"),
    (" ", "both", " ", "B OW TH"),
    (" ", "bus", "#", "B IH Z"),
    ("", "buil", "", "B IH L"),
    ("", "b", "", "B"),

    (" ", "ch", "^", "K"),
    ("^e", "ch", "", "K"),
    ("", "ch", "", "CH"),
    (" s", "ci", "#", "S AY"),
    ("", "ci", "a", "SH"),
    ("", "ci", "o", "SH"),
    ("", "ci", "en", "SH"),
    ("", "cci", " ", "CH IY"),  # Italian-name final -cci (bucci, ricci)
    ("", "cc", "+", "K S"),
    ("c", "c", "", ""),
    ("", "c", "+", "S"),
    ("", "ck", "", "K"),
    ("", "com", "%", "K AH M"),
    ("", "c", "", "K"),

    ("#:", "ded", " ", "D IH D"),
    ("d", "d", "", ""),
    (".e", "d", " ", "D"),
    ("#:^e", "d", " ", "T"),
    (" ", "de", "^#", "D IH"),
    (" ", "do", " ", "D UW"),
    (" ", "does", "", "D AH Z"),
    (" ", "doing", "", "D UW IH NG"),
    (" ", "dow", "", "D AW"),
    ("", "du", "a", "JH UW"),
    ("", "d", "", "D"),

    ("", "eaux", " ", "OW"),  # French -eaux/-eux name endings
    ("", "eux", " ", "OW"),
    ("#:", "e", " ", ""),
    ("':^", "e", " ", ""),
    (" :", "e", " ", "IY"),
    ("#", "ed", " ", "D"),
    ("#:", "e", "d ", ""),
    ("", "ev", "er", "EH V"),
    ("", "e", "^%", "IY"),
    ("", "eri", "#", "IY R IY"),
    ("", "eri", "", "EH R IH"),
    ("#:", "er", "#", "ER"),
    ("", "er", "#", "EH R"),
    ("", "er", "", "ER"),
    (" ", "even", "", "IY V EH N"),
    ("#:", "e", "w", ""),
    ("@", "ew", "", "UW"),
    ("", "ew", "", "Y UW"),
    ("", "e", "o", "IY"),
    ("#:&", "es", " ", "IH Z"),
    ("#:", "e", "s ", ""),
    ("#:", "ely", " ", "L IY"),
    ("#:", "ement", "", "M EH N T"),
    ("", "eful", "", "F UH L"),
    ("", "ee", "", "IY"),
    ("", "earn", "", "ER N"),
    (" ", "ear", "^", "ER"),
    ("", "ead", "", "EH D"),
    ("#:", "ea", " ", "IY AX"),
    ("", "ea", "su", "EH"),
    ("", "ea", "", "IY"),
    ("", "eigh", "", "EY"),
    ("", "ei", "", "IY"),
    (" ", "eye", "", "AY"),
    ("", "ey", "", "IY"),
    ("", "eu", "", "Y UW"),
    ("", "e", "", "EH"),

    ("", "ful", "", "F UH L"),
    ("f", "f", "", ""),
    ("", "f", "", "F"),

    ("", "giv", "", "G IH V"),
    # word-final -gue is a hard /g/ (vague, league, fatigue, catalogue);
    # word-initial ar- keeps the /gyu/ (argue, argues, argued).
    (" ", "guy", "", "G AY"),
    (" ar", "gue", "", "G Y UW"),
    ("", "gues", " ", "G Z"),
    ("", "gued", " ", "G D"),
    ("", "gue", " ", "G"),
    # word-initial gu+vowel has a silent u (guest, guide, guard, guitar);
    # medially it is usually /gw/ (linguist, language), left to general rules.
    (" ", "gu", "#", "G"),
    (" ", "g", "i^", "G"),
    ("", "ge", "t", "G EH"),
    ("su", "gges", "", "G JH EH S"),
    ("", "gg", "", "G"),
    (" b#", "g", "", "G"),
    ("", "g", "+", "JH"),
    ("", "great", "", "G R EY T"),
    ("#", "gh", "", ""),
    ("", "g", "", "G"),

    (" ", "hav", "", "HH AE V"),
    (" ", "here", "", "HH IY R"),
    (" ", "hour", "", "AW ER"),
    ("", "how", "", "HH AW"),
    ("", "h", "#", "HH"),
    ("", "h", "", ""),

    (" ", "in", "", "IH N"),
    ("", "i", "gue", "IY"),  # fatigue, intrigue
    (" ", "i", " ", "AY"),
    ("", "in", "d", "AY N"),
    ("", "ier", "", "IY ER"),
    ("#:r", "ied", "", "IY D"),
    ("", "ied", " ", "AY D"),
    ("", "ien", "", "IY EH N"),
    ("", "ie", "t", "AY EH"),
    (" :", "i", "%", "AY"),
    ("", "i", "%", "IY"),
    ("", "ie", "", "IY"),
    ("", "i", "^+:#", "IH"),
    ("", "ir", "#", "AY R"),
    ("", "iz", "%", "AY Z"),
    ("", "is", "%", "AY Z"),
    ("", "i", "d%", "AY"),
    ("+^", "i", "^+", "IH"),
    ("", "i", "t%", "AY"),
    ("#:^", "i", "^+", "IH"),
    ("", "i", "^+", "AY"),
    ("", "ir", "", "ER"),
    ("", "igh", "", "AY"),
    ("", "ild", "", "AY L D"),
    ("", "ign", " ", "AY N"),
    ("", "ign", "^", "AY N"),
    ("", "ign", "%", "AY N"),
    ("", "ique", "", "IY K"),
    ("", "i", "", "IH"),

    ("", "j", "", "JH"),

    (" ", "k", "n", ""),
    ("", "k", "", "K"),

    ("", "lo", "c#", "L OW"),
    ("", "logue", "", "L AO G"),  # catalogue, dialogue, monologue
    ("l", "l", "", ""),
    ("#:^", "l", "%", "AX L"),
    (" ", "lead", "", "L IY D"),
    ("", "l", "", "L"),

    ("", "mov", "", "M UW V"),
    ("m", "m", "", ""),
    ("", "m", "", "M"),

    ("e", "ng", "+", "N JH"),
    ("", "ng", "r", "NG G"),
    ("", "ng", "#", "NG G"),
    ("", "ngl", "%", "NG G AX L"),
    ("", "ng", "", "NG"),
    ("", "nk", "", "NG K"),
    (" ", "now", " ", "N AW"),
    ("n", "n", "", ""),
    ("", "n", "", "N"),

    ("", "of", " ", "AX V"),
    ("", "orough", "", "ER OW"),
    ("#:", "or", " ", "ER"),
    ("#:", "ors", " ", "ER Z"),
    ("", "or", "", "AO R"),
    (" ", "one", "", "W AH N"),
    ("", "ow", "", "OW"),
    (" ", "over", "", "OW V ER"),
    ("", "ov", "", "AH V"),
    ("", "o", "gue", "OW"),  # rogue, vogue, brogue
    ("", "o", "^%", "OW"),
    ("", "o", "^en", "OW"),
    ("", "o", "^i#", "OW"),
    ("", "ol", "d", "OW L"),
    ("", "ought", "", "AO T"),
    ("", "ough", "", "AH F"),
    (" ", "ou", "", "AW"),
    ("h", "ou", "s#", "AW"),
    ("", "ous", "", "AX S"),
    ("", "our", "", "AO R"),
    ("", "ould", "", "UH D"),
    ("^", "ou", "^l", "AH"),
    ("", "oup", "", "UW P"),
    ("", "ou", "", "AW"),
    ("", "oy", "", "OY"),
    ("", "oing", "", "OW IH NG"),
    ("", "oi", "", "OY"),
    ("", "oor", "", "AO R"),
    ("", "ook", "", "UH K"),
    ("", "ood", "", "UH D"),
    ("", "oo", "", "UW"),
    ("", "o", "e", "OW"),
    ("", "o", " ", "OW"),
    ("", "oa", "", "OW"),
    (" ", "only", "", "OW N L IY"),
    (" ", "once", "", "W AH N S"),
    ("", "on't", "", "OW N T"),
    ("c", "o", "n", "AA"),
    ("", "o", "ng", "AO"),
    (" :^", "o", "n", "AH"),
    ("i", "on", "", "AX N"),
    ("#:", "on", " ", "AX N"),
    ("#^", "on", "", "AX N"),
    ("", "o", "st ", "OW"),
    ("", "of", "^", "AO F"),
    ("", "other", "", "AH DH ER"),
    ("", "oss", " ", "AO S"),
    ("#:^", "om", "", "AH M"),
    ("", "o", "", "AA"),

    ("", "ph", "", "F"),
    (" ", "ps", "", "S"),
    ("p", "p", "", ""),
    ("", "peop", "", "P IY P"),
    ("", "pow", "", "P AW"),
    ("", "put", " ", "P UH T"),
    ("", "p", "", "P"),

    ("", "quar", "", "K W AO R"),
    # word-final -que is a plain /k/ (torque, mosque, cheque, plaque).
    ("", "ques", " ", "K S"),
    ("", "que", " ", "K"),
    ("", "qu", "", "K W"),
    ("", "q", "", "K"),

    (" ", "re", "^#", "R IY"),
    ("r", "r", "", ""),
    ("", "r", "", "R"),

    ("", "sch", "^", "SH"),   # schmidt/schneider; school keeps s-ch via #
    ("", "sh", "", "SH"),
    ("#", "sion", "", "ZH AX N"),
    ("", "some", "", "S AH M"),
    ("#", "sur", "#", "ZH ER"),
    ("", "sur", "#", "SH ER"),
    ("#", "su", "#", "ZH UW"),
    ("#", "ssu", "#", "SH UW"),
    ("#", "sed", " ", "Z D"),
    ("#", "s", "#", "Z"),
    ("", "said", "", "S EH D"),
    ("^", "sion", "", "SH AX N"),
    ("", "s", "s", ""),
    (".", "s", " ", "Z"),
    ("#:.e", "s", " ", "Z"),
    ("#:^#", "s", " ", "S"),
    ("u", "s", " ", "S"),
    (" :#", "s", " ", "Z"),
    (" ", "sch", "", "S K"),
    ("#", "sch", " ", "SH"),  # German-name final -sch (rausch, busch)
    ("", "s", "c+", ""),
    ("#", "sm", "", "Z M"),
    ("#", "sn", "'", "Z AX N"),
    ("", "s", "", "S"),

    # Germanic/French loan clusters common in English names (generic
    # borrowings the NRL native ruleset predates): tsch -> CH
    ("", "tsch", "", "CH"),
    ("t", "t", "", ""),
    (" ", "the", " ", "DH AX"),
    ("", "to", " ", "T UW"),
    ("", "that", "", "DH AE T"),
    (" ", "this", " ", "DH IH S"),
    (" ", "they", "", "DH EY"),
    (" ", "there", "", "DH EH R"),
    ("", "ther", "", "DH ER"),
    ("", "their", "", "DH EH R"),
    (" ", "than", " ", "DH AE N"),
    (" ", "them", " ", "DH EH M"),
    ("", "these", " ", "DH IY Z"),
    (" ", "then", "", "DH EH N"),
    ("", "through", "", "TH R UW"),
    ("", "those", "", "DH OW Z"),
    ("", "though", " ", "DH OW"),
    (" ", "thus", "", "DH AH S"),
    ("", "th", "", "TH"),
    ("#:", "ted", " ", "T IH D"),
    ("s", "ti", "#n", "CH"),
    ("", "ti", "o", "SH"),
    ("", "ti", "a", "SH"),
    ("", "tien", "", "SH AX N"),
    ("", "tur", "#", "CH ER"),
    ("", "tu", "a", "CH UW"),
    (" ", "two", "", "T UW"),
    ("", "t", "", "T"),

    # leftover -ue after a consumed g (to-ngue) is silent at word end.
    ("", "uy", "", "AY"),     # buy, buyer; guy handled in the g group
    ("g", "ues", " ", "Z"),
    ("g", "ued", " ", "D"),
    ("g", "ue", " ", ""),
    (" ", "un", "i", "Y UW N"),
    (" ", "un", "", "AH N"),
    (" ", "upon", "", "AX P AO N"),
    ("@", "ur", "#", "UH R"),
    ("", "ur", "#", "Y UH R"),
    ("", "ur", "", "ER"),
    ("", "u", "^ ", "AH"),
    ("", "u", "^^", "AH"),
    ("", "u", "^%", "UW"),
    ("@", "u", "", "UW"),
    ("", "u", "", "Y UW"),

    ("", "view", "", "V Y UW"),
    ("", "v", "", "V"),

    (" ", "were", "", "W ER"),
    ("", "wa", "s", "W AA"),
    ("", "wa", "t", "W AA"),
    ("", "where", "", "W EH R"),
    ("", "what", "", "W AA T"),
    ("", "whol", "", "HH OW L"),
    ("", "who", "", "HH UW"),
    ("", "wh", "", "W"),
    ("", "war", "", "W AO R"),
    ("", "wor", "^", "W ER"),
    ("", "wr", "", "R"),
    ("", "w", "", "W"),

    ("", "x", "", "K S"),

    ("", "young", "", "Y AH NG"),
    (" ", "you", "", "Y UW"),
    (" ", "yes", "", "Y EH S"),
    (" ", "y", "", "Y"),
    ("#:^", "y", " ", "IY"),
    ("#:^", "y", "i", "IY"),
    (" :", "y", " ", "AY"),
    (" :", "y", "#", "AY"),
    (" :", "y", "^+:#", "IH"),
    (" :", "y", "^#", "AY"),
    ("", "y", "", "IH"),

    ("", "z", "", "Z"),
]


@lru_cache(maxsize=1)
def _rules_by_first_letter():
    table: dict = {}
    for left, frag, right, phones in _R:
        table.setdefault(frag[0], []).append((left, frag, right, phones.split() if phones else []))
    return table


def _match_left(word: str, pos: int, pattern: str) -> bool:
    """Match `pattern` (right-to-left) against word[:pos]."""
    i = pos
    for ch in reversed(pattern):
        if ch == "#":
            if i <= 0 or word[i - 1] not in _VOWELS:
                return False
            i -= 1
            while i > 0 and word[i - 1] in _VOWELS:
                i -= 1
        elif ch == ":":
            while i > 0 and word[i - 1] not in _VOWELS and word[i - 1] != " ":
                i -= 1
        elif ch == "^":
            if i <= 0 or word[i - 1] in _VOWELS or word[i - 1] == " ":
                return False
            i -= 1
        elif ch == ".":
            if i <= 0 or word[i - 1] not in _VOICED:
                return False
            i -= 1
        elif ch == "+":
            if i <= 0 or word[i - 1] not in "eiy":
                return False
            i -= 1
        elif ch == " ":
            if i != 0 and word[i - 1] != " ":
                return False
            i = max(i - 1, 0)
        else:
            if i <= 0 or word[i - 1] != ch:
                return False
            i -= 1
    return True


def _match_right(word: str, pos: int, pattern: str) -> bool:
    """Match `pattern` (left-to-right) against word[pos:]."""
    i, n = pos, len(word)

    def at(j):
        return word[j] if j < n else " "

    for ch in pattern:
        if ch == "#":
            if at(i) not in _VOWELS:
                return False
            i += 1
            while at(i) in _VOWELS:
                i += 1
        elif ch == ":":
            while at(i) not in _VOWELS and at(i) != " ":
                i += 1
        elif ch == "^":
            if at(i) in _VOWELS or at(i) == " ":
                return False
            i += 1
        elif ch == ".":
            if at(i) not in _VOICED:
                return False
            i += 1
        elif ch == "+":
            if at(i) not in "eiy":
                return False
            i += 1
        elif ch == "%":
            if at(i) == "e":
                if at(i + 1) == "r":
                    i += 2
                elif at(i + 1) in "sd":
                    i += 2
                elif word[i + 1 : i + 3] == "ly":
                    i += 3
                else:
                    i += 1
            elif word[i : i + 3] == "ing":
                i += 3
            else:
                return False
        elif ch == "&":
            if word[i : i + 2] in _SIBILANT_2:
                i += 2
            elif at(i) in _SIBILANT_1:
                i += 1
            else:
                return False
        elif ch == "@":
            if word[i : i + 2] in _AT_2:
                i += 2
            elif at(i) in _AT_1:
                i += 1
            else:
                return False
        elif ch == " ":
            if at(i) != " ":
                return False
            i += 1
        else:
            if at(i) != ch:
                return False
            i += 1
    return True


_VOWEL_PHONES = {
    "AA", "AE", "AH", "AO", "AW", "AX", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}


def lts(word: str) -> List[str]:
    """Word (letters only) -> ARPAbet with stress digits on vowels.

    The first vowel gets primary stress (1); the rest get 0.  AX (schwa,
    not in CMU's stressed inventory) maps to AH0 always.
    """
    word = re.sub(r"[^a-z']", "", word.lower())
    if not word:
        return []
    table = _rules_by_first_letter()
    pos = 0
    out: List[str] = []
    n = len(word)
    while pos < n:
        letter = word[pos]
        matched = False
        for left, frag, right, phones in table.get(letter, ()):
            if word[pos : pos + len(frag)] != frag:
                continue
            if not _match_left(word, pos, left):
                continue
            if not _match_right(word, pos + len(frag), right):
                continue
            out.extend(phones)
            pos += len(frag)
            matched = True
            break
        if not matched:
            pos += 1  # unknown letter: skip
    # stress assignment
    result: List[str] = []
    stressed = False
    for p in out:
        if p == "AX":
            result.append("AH0")
        elif p in _VOWEL_PHONES:
            result.append(p + ("1" if not stressed else "0"))
            stressed = True
        else:
            result.append(p)
    return result


# ---------------------------------------------------------------------------
# Morphological suffix stripping against a pronunciation dictionary.
# ---------------------------------------------------------------------------

_UNVOICED = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIB = {"S", "Z", "SH", "ZH", "CH", "JH"}


def _plural_phones(stem_phones: Sequence[str]) -> List[str]:
    last = re.sub(r"\d", "", stem_phones[-1]) if stem_phones else ""
    if last in _SIB:
        return ["IH0", "Z"]
    if last in _UNVOICED:
        return ["S"]
    return ["Z"]


def _past_phones(stem_phones: Sequence[str]) -> List[str]:
    last = re.sub(r"\d", "", stem_phones[-1]) if stem_phones else ""
    if last in {"T", "D"}:
        return ["IH0", "D"]
    if last in _UNVOICED:
        return ["T"]
    return ["D"]


def stem_lookup(word: str, lookup) -> Optional[List[str]]:
    """Try to pronounce `word` as stem+inflection with the stem in `lookup`.

    `lookup(w)` returns a flat ARPA phone list (with stress digits) or None.
    Handles -'s/-s/-es, -ed, -ing, -ly, -er, -est, -ness, -ment, -ful with
    e-restoration and consonant-doubling undo.  Returns None if no stem fits.
    """
    w = word.lower()

    def stems(base: str):
        yield base
        yield base + "e"                      # mak(ing) -> make
        if len(base) >= 2 and base[-1] == base[-2]:
            yield base[:-1]                   # stopp(ed) -> stop
        if base.endswith("i"):
            yield base[:-1] + "y"             # happi(ly/er) -> happy

    def try_suffix(suffix: str, phones_fn) -> Optional[List[str]]:
        if not w.endswith(suffix) or len(w) <= len(suffix):
            return None
        base = w[: -len(suffix)]
        for stem in stems(base):
            ph = lookup(stem)
            if ph:
                return list(ph) + phones_fn(ph)
        return None

    if w.endswith("'s"):
        ph = lookup(w[:-2])
        if ph:
            return list(ph) + _plural_phones(ph)
    if w.endswith("ies") and len(w) > 3:      # carries -> carry + Z
        ph = lookup(w[:-3] + "y")
        if ph:
            return list(ph) + ["Z"]
    if w.endswith("ied") and len(w) > 3:      # carried -> carry + D
        ph = lookup(w[:-3] + "y")
        if ph:
            return list(ph) + ["D"]
    for suffix, fn in (
        ("es", _plural_phones),
        ("s", _plural_phones),
        ("ed", _past_phones),
        ("ing", lambda ph: ["IH0", "NG"]),
        ("ly", lambda ph: ["L", "IY0"]),
        ("er", lambda ph: ["ER0"]),
        ("est", lambda ph: ["AH0", "S", "T"]),
        ("ness", lambda ph: ["N", "AH0", "S"]),
        ("ment", lambda ph: ["M", "AH0", "N", "T"]),
        ("ful", lambda ph: ["F", "AH0", "L"]),
    ):
        got = try_suffix(suffix, fn)
        if got:
            return got
    return None
