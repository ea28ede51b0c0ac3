"""Japanese text frontend.

Parity surface with the reference (`text/japanese.py`): pyopenjtalk G2P with
sokuon (Q) / hatsuon (N) phonetic rewrites.  pyopenjtalk handles kanji; when
it is unavailable this module still converts kana text through a native
kana -> romaji table (covering the reference's JA phoneme inventory), so kana
input works in minimal environments.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from latent_diffusion_speech_tpu_torch.text.symbols import symbols

_POST_REP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?", "\n": ".",
    "·": ",", "、": ",", "...": "…", "v": "V",
}

_KATAKANA_ROMAJI = {
    "ア": "a", "イ": "i", "ウ": "u", "エ": "e", "オ": "o",
    "カ": "k a", "キ": "k i", "ク": "k u", "ケ": "k e", "コ": "k o",
    "ガ": "g a", "ギ": "g i", "グ": "g u", "ゲ": "g e", "ゴ": "g o",
    "サ": "s a", "シ": "sh i", "ス": "s u", "セ": "s e", "ソ": "s o",
    "ザ": "z a", "ジ": "j i", "ズ": "z u", "ゼ": "z e", "ゾ": "z o",
    "タ": "t a", "チ": "ch i", "ツ": "ts u", "テ": "t e", "ト": "t o",
    "ダ": "d a", "ヂ": "j i", "ヅ": "z u", "デ": "d e", "ド": "d o",
    "ナ": "n a", "ニ": "n i", "ヌ": "n u", "ネ": "n e", "ノ": "n o",
    "ハ": "h a", "ヒ": "h i", "フ": "f u", "ヘ": "h e", "ホ": "h o",
    "バ": "b a", "ビ": "b i", "ブ": "b u", "ベ": "b e", "ボ": "b o",
    "パ": "p a", "ピ": "p i", "プ": "p u", "ペ": "p e", "ポ": "p o",
    "マ": "m a", "ミ": "m i", "ム": "m u", "メ": "m e", "モ": "m o",
    "ヤ": "y a", "ユ": "y u", "ヨ": "y o",
    "ラ": "r a", "リ": "r i", "ル": "r u", "レ": "r e", "ロ": "r o",
    "ワ": "w a", "ヲ": "o", "ン": "N", "ッ": "cl",  # ー handled positionally
    # yoon digraph second elements handled in _kana_to_phones
    "キャ": "ky a", "キュ": "ky u", "キョ": "ky o",
    "ギャ": "gy a", "ギュ": "gy u", "ギョ": "gy o",
    "シャ": "sh a", "シュ": "sh u", "ショ": "sh o",
    "ジャ": "j a", "ジュ": "j u", "ジョ": "j o",
    "チャ": "ch a", "チュ": "ch u", "チョ": "ch o",
    "ニャ": "ny a", "ニュ": "ny u", "ニョ": "ny o",
    "ヒャ": "hy a", "ヒュ": "hy u", "ヒョ": "hy o",
    "ビャ": "by a", "ビュ": "by u", "ビョ": "by o",
    "ピャ": "py a", "ピュ": "py u", "ピョ": "py o",
    "ミャ": "my a", "ミュ": "my u", "ミョ": "my o",
    "リャ": "ry a", "リュ": "ry u", "リョ": "ry o",
    # foreign-sound digraphs (katakana + small vowel), per openjtalk
    "ファ": "f a", "フィ": "f i", "フェ": "f e", "フォ": "f o",
    "ティ": "t i", "トゥ": "t u", "ディ": "d i", "ドゥ": "d u",
    "デュ": "dy u",
    "ウィ": "w i", "ウェ": "w e", "ウォ": "w o",
    "シェ": "sh e", "ジェ": "j e", "チェ": "ch e",
    "ツァ": "ts a", "ツィ": "ts i", "ツェ": "ts e", "ツォ": "ts o",
    "イェ": "y e",
    "ヴァ": "v a", "ヴィ": "v i", "ヴェ": "v e", "ヴォ": "v o",
    "ヴ": "v u",
}

# small vowels not consumed by a digraph replace the preceding vowel
# (approximating the foreign mora): クァ -> k a, フョ etc. fall back here.
_SMALL_VOWELS = {"ァ": "a", "ィ": "i", "ゥ": "u", "ェ": "e", "ォ": "o"}


def post_replace_ph(ph: str) -> str:
    ph = _POST_REP.get(ph, ph)
    return ph if ph in symbols else "UNK"


def _hira_to_kata(text: str) -> str:
    return "".join(
        chr(ord(c) + 0x60) if "ぁ" <= c <= "ゖ" else c for c in text
    )


def _kana_to_phones(text: str) -> List[str]:
    kata = _hira_to_kata(text)
    phones: List[str] = []
    i = 0
    while i < len(kata):
        pair = kata[i : i + 2]
        if len(pair) == 2 and pair in _KATAKANA_ROMAJI:
            phones += _KATAKANA_ROMAJI[pair].split()
            i += 2
            continue
        ch = kata[i]
        if ch == "ー":
            # chouonpu lengthens the previous vowel (openjtalk: doubled vowel)
            if phones and phones[-1] in "aiueo":
                phones.append(phones[-1])
        elif ch == "ウ" and i > 0 and kata[i - 1] == "ョ":
            # ょう is ALWAYS a long o (volitional ましょう/でしょう, Sino-
            # Japanese きょう) — never an okurigana mora, unlike plain
            # o-row + う (思う), so the rewrite is safe on raw kana input
            phones.append("o")
        elif ch in _SMALL_VOWELS:
            if phones and phones[-1] in "aiueo":
                phones[-1] = _SMALL_VOWELS[ch]
            else:
                phones.append(_SMALL_VOWELS[ch])
        elif ch in _KATAKANA_ROMAJI:
            mapped = _KATAKANA_ROMAJI[ch]
            if mapped:
                phones += mapped.split()
        elif ch in _POST_REP or ch in symbols:
            phones.append(ch)
        i += 1
    return phones


def text_normalize(text: str) -> str:
    return text.replace("％", "パーセント")


from functools import lru_cache


# conjugation continuations per dropped dictionary-form final: a stem match
# is accepted only when the NEXT hiragana is a plausible inflection for the
# verb class (so 会う's stem 会/あ fires for 会って but not for 展覧会です,
# where the per-char かい is right).  る unions godan and ichidan sets —
# okurigana alone cannot separate 帰る(godan) from 起きる(ichidan).
_STEM_NEXT = {
    "う": set("わいうえおっ"),
    "く": set("かきくけこい"),
    "ぐ": set("がぎぐげごい"),
    "す": set("さしすせそ"),
    "つ": set("たちつてとっ"),
    "ぬ": set("なにぬねのん"),
    "ぶ": set("ばびぶべぼん"),
    "む": set("まみむめもん"),
    "る": set("らりるれろっ" "てたまなよずざす"),  # す: 〜すぎる compounds
    "い": set("くかけさそ"),
}


@lru_cache(maxsize=1)
def _kanji_table() -> tuple:
    """Vendored kanji -> kana readings; used only when pyopenjtalk is absent.
    Approximate by design — no morphological analysis — but keeps raw-kanji
    input functional offline.

    Returns (words, stems).  Two derived layers on top of the file:
    * duplicate keys keep the FIRST (word-section) reading — the per-char
      counter section lists e.g. 頭 とう, but standalone prose wants あたま;
    * every conjugable entry (okurigana dictionary form: …る/う/く/…/い)
      also registers its stem (key and reading minus the shared final kana)
      in `stems`, mapping stem -> (reading, allowed_next): 起きる->起き
      covers 起きて/起きた/起きます, 強い->強 covers 強くて, 働く->働
      covers 働いて.  来る is skipped (irregular: 来て is き, not く)."""
    from latent_diffusion_speech_tpu_torch.text.data_files import find_data_file

    path = find_data_file("kanji_table.txt")
    table: dict = {}
    stems: dict = {}
    if path is not None:
        for line in path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 2:
                table.setdefault(parts[0], parts[1])
        for key, reading in table.items():
            if (
                len(key) >= 2
                and key != "来る"
                and key[-1] in _STEM_NEXT
                and key[-1] == reading[-1:]
            ):
                stems.setdefault(key[:-1], (reading[:-1], _STEM_NEXT[key[-1]]))
    return table, stems


_O_ROW = set("おこごそぞとどのほぼぽもよろょを")
_E_ROW = set("えけげせぜてでねへべぺめれ")


def _long_vowelize(key: str, reading: str) -> str:
    """openjtalk writes long vowels as doubled vowels: within one word,
    o-row+う and e-row+い are long (きょう -> きょー -> ky o o, せんせい ->
    せんせー -> s e N s e e).  A final う/い that is okurigana in the key
    (dictionary-form verbs/adjectives: 思う, 優しい) is a real mora and
    stays literal."""
    out: List[str] = []
    n = len(reading)
    protect_final = reading[-1:] in "うい" and key[-1:] == reading[-1:]
    for i, c in enumerate(reading):
        prev = reading[i - 1] if i else ""
        if c == "う" and prev in _O_ROW and not (protect_final and i == n - 1):
            out.append("ー")
        elif c == "い" and prev in _E_ROW and not (protect_final and i == n - 1):
            out.append("ー")
        else:
            out.append(c)
    return "".join(out)


# raw-text long-o rewrite set: o-row kana whose う continuation in running
# text is (almost) always a long vowel (よう/もう/そう/どう/ありがとう…).
# Deliberately EXCLUDES の/を/と, where a following う usually starts the
# next word (そのうち, 〜を受け, 〜すると うまく), and excludes e-row+い
# entirely (ている/てください would corrupt).  Okurigana う (思う, 買う) is
# safe: in raw text it follows a KANJI, not an o-row kana.  The kanji-table
# readings get the full treatment in _long_vowelize, key-aware.
_O_ROW_RAW = _O_ROW - set("のをと")


# fixed kana words whose long vowel uses an excluded row (と+う)
_RAW_WORD_LONG = {"ありがとう": "ありがとー", "おめでとう": "おめでとー",
                  "とうとう": "とーとー"}


def _raw_long_vowels(text: str) -> str:
    for k, v in _RAW_WORD_LONG.items():
        if k in text:
            text = text.replace(k, v)
    out = list(text)
    for i in range(1, len(text)):
        if text[i] == "う" and text[i - 1] in _O_ROW_RAW:
            out[i] = "ー"
    return "".join(out)


def _is_kanji(c: str) -> bool:
    return "一" <= c <= "鿿" or c == "々"


def _is_word_char(c: str) -> bool:
    # ー (chouonpu) ends katakana words (エレベーター); digits end numbers —
    # both are word positions for the particle heuristic below
    return (_is_kanji(c) or "ァ" <= c <= "ヶ" or c == "ー"
            or "0" <= c <= "9" or "０" <= c <= "９")


def _particles(text: str) -> str:
    """Pronounce the topic/direction particles は->わ, へ->え.  Without
    morphology the heuristic is: a は/へ directly AFTER a word character
    (kanji/katakana/chouonpu/digit) is a particle — okurigana never starts
    with は/へ in common vocabulary, so the false-positive surface is
    negligible.  After a HIRAGANA word (それは本当…) the next character
    decides: a は/へ that sits on a word boundary — followed by kanji,
    katakana, a digit, punctuation, or the end of text — is a particle
    (それは/つまりは/どこへ); a hiragana follower means word-internal
    (おはよう, やはり) and is left alone."""
    out = list(text)
    n = len(text)
    for i, c in enumerate(text):
        if c not in "はへ" or i == 0:
            continue
        prev = text[i - 1]
        if _is_word_char(prev):
            out[i] = "わ" if c == "は" else "え"
        elif "ぁ" <= prev <= "ゖ":
            nxt = text[i + 1] if i + 1 < n else ""
            # a following あ is also a boundary (〜はあります/はあなた);
            # no common word carries an internal はあ
            if (nxt == "" or _is_word_char(nxt) or nxt == "あ"
                    or not ("ぁ" <= nxt <= "ゖ")):
                out[i] = "わ" if c == "は" else "え"
    return "".join(out)


# -- numbers, counters, dates (pyopenjtalk-absent fallback) -------------------
#
# Arabic numerals have no kana table entry and used to drop silently ("3時"
# lost the 3); kanji numerals fell back to per-character readings with none
# of the counter euphonics (一本 -> いちほん).  This is the textbook layer a
# morphological dictionary encodes: number-to-kana with the standard sound
# changes (さんびゃく/ろっぴゃく/さんぜん), per-counter assimilations
# (いっぽん/さんぼん/じゅっぷん), native whole-number counter readings
# (ひとつ/ふたり/はたち), and date readings (四月ついたち).

_NUM_U = {1: "いち", 2: "に", 3: "さん", 4: "よん", 5: "ご",
          6: "ろく", 7: "なな", 8: "はち", 9: "きゅう"}
_NUM_HUN = {1: "ひゃく", 3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"}
_NUM_SEN = {1: "せん", 3: "さんぜん", 8: "はっせん"}
_KANJI_DIGIT = {"〇": 0, "一": 1, "二": 2, "三": 3, "四": 4, "五": 5,
                "六": 6, "七": 7, "八": 8, "九": 9}
_KANJI_MULT = {"十": 10, "百": 100, "千": 1000, "万": 10000}


def _num_kana(n: int) -> str:
    """0..99,999,999 -> kana with the standard euphonic changes."""
    if n == 0:
        return "ぜろ"
    if n >= 10000:
        man, rest = divmod(n, 10000)
        return _num_kana(man) + "まん" + (_num_kana(rest) if rest else "")
    parts: List[str] = []
    th, n = divmod(n, 1000)
    hu, n = divmod(n, 100)
    te, u = divmod(n, 10)
    if th:
        parts.append(_NUM_SEN.get(th, _NUM_U[th] + "せん"))
    if hu:
        parts.append(_NUM_HUN.get(hu, _NUM_U[hu] + "ひゃく"))
    if te:
        parts.append(("" if te == 1 else _NUM_U[te]) + "じゅう")
    if u:
        parts.append(_NUM_U[u])
    return "".join(parts)


def _parse_number(s: str) -> int:
    """Arabic (half/full-width) or kanji numeral string -> int."""
    if s[0] in _KANJI_DIGIT or s[0] in _KANJI_MULT:
        total = cur = 0
        for c in s:
            if c in _KANJI_DIGIT:
                cur = cur * 10 + _KANJI_DIGIT[c]
            else:
                m = _KANJI_MULT[c]
                if m == 10000:
                    total = (total + (cur or 1)) * m
                    cur = 0
                else:
                    total += (cur or 1) * m
                    cur = 0
        return total + cur
    return int("".join(chr(ord(c) - 0xFEE0) if "０" <= c <= "９" else c
                       for c in s))


# counter -> (default suffix, euphonic last-digit fragments, whole-number
# native readings).  last maps final digit (or 10 for round tens, where the
# closing じゅう itself assimilates: 30本 さんじゅっぽん) to the full
# digit+counter fragment.
_COUNTERS = {
    "時間": ("じかん", {4: "よじかん", 7: "しちじかん", 9: "くじかん"}, {}),
    "週間": ("しゅうかん", {1: "いっしゅうかん", 8: "はっしゅうかん",
                            10: "じゅっしゅうかん"}, {}),
    "ヶ月": ("かげつ", {1: "いっかげつ", 6: "ろっかげつ", 8: "はっかげつ",
                        10: "じゅっかげつ"}, {}),
    "か月": ("かげつ", {1: "いっかげつ", 6: "ろっかげつ", 8: "はっかげつ",
                        10: "じゅっかげつ"}, {}),
    "時": ("じ", {4: "よじ", 7: "しちじ", 9: "くじ"}, {}),
    "分": ("ふん", {1: "いっぷん", 3: "さんぷん", 4: "よんぷん",
                    6: "ろっぷん", 8: "はっぷん", 10: "じゅっぷん"}, {}),
    "秒": ("びょう", {}, {}),
    "歳": ("さい", {1: "いっさい", 8: "はっさい", 10: "じゅっさい"},
           {20: "はたち"}),
    "才": ("さい", {1: "いっさい", 8: "はっさい", 10: "じゅっさい"},
           {20: "はたち"}),
    "人": ("にん", {4: "よにん"}, {1: "ひとり", 2: "ふたり"}),
    "回": ("かい", {1: "いっかい", 6: "ろっかい", 8: "はっかい",
                    10: "じゅっかい"}, {}),
    "階": ("かい", {1: "いっかい", 3: "さんがい", 6: "ろっかい",
                    8: "はっかい", 10: "じゅっかい"}, {}),
    "本": ("ほん", {1: "いっぽん", 3: "さんぼん", 6: "ろっぽん",
                    8: "はっぽん", 10: "じゅっぽん"}, {}),
    "個": ("こ", {1: "いっこ", 6: "ろっこ", 8: "はっこ", 10: "じゅっこ"}, {}),
    "冊": ("さつ", {1: "いっさつ", 8: "はっさつ", 10: "じゅっさつ"}, {}),
    "匹": ("ひき", {1: "いっぴき", 3: "さんびき", 6: "ろっぴき",
                    8: "はっぴき", 10: "じゅっぴき"}, {}),
    "杯": ("はい", {1: "いっぱい", 3: "さんばい", 6: "ろっぱい",
                    8: "はっぱい", 10: "じゅっぱい"}, {}),
    "枚": ("まい", {}, {}),
    "台": ("だい", {}, {}),
    "番": ("ばん", {}, {}),
    "度": ("ど", {}, {}),
    "名様": ("めいさま", {}, {}),
    "名": ("めい", {}, {}),
    "泊": ("はく", {1: "いっぱく", 3: "さんぱく", 6: "ろっぱく",
                    8: "はっぱく", 10: "じゅっぱく"}, {}),
    "円玉": ("えんだま", {4: "よえんだま"}, {}),
    "円": ("えん", {4: "よえん"}, {}),
    "年": ("ねん", {4: "よねん"}, {}),
    "つ": ("", {}, {1: "ひとつ", 2: "ふたつ", 3: "みっつ", 4: "よっつ",
                    5: "いつつ", 6: "むっつ", 7: "ななつ", 8: "やっつ",
                    9: "ここのつ", 10: "とお"}),
    # katakana measure words: reading is the unit itself, no assimilation
    "グラム": ("グラム", {}, {}),
    "キロ": ("キロ", {}, {}),
    "メートル": ("メートル", {}, {}),
    "センチ": ("センチ", {}, {}),
    "ミリ": ("ミリ", {}, {}),
    "リットル": ("リットル", {}, {}),
    "ページ": ("ページ", {}, {}),
    "パーセント": ("パーセント", {}, {}),
}

# day-of-month: native readings through 10 plus the irregular teens/twenties
_DAYS = {1: "ついたち", 2: "ふつか", 3: "みっか", 4: "よっか", 5: "いつか",
         6: "むいか", 7: "なのか", 8: "ようか", 9: "ここのか", 10: "とおか",
         14: "じゅうよっか", 20: "はつか", 24: "にじゅうよっか"}


def _counted(n: int, suffix: str, last: dict, whole: dict) -> str:
    if n in whole:
        return whole[n]
    if n == 0:
        return "ぜろ" + suffix
    u = n % 10
    if u == 0 and n >= 10:
        # the closing じゅう assimilates (30本 さんじゅっぽん) — but only
        # when the reading actually ends in じゅう: round hundreds/
        # thousands (100本) must NOT strip ひゃく/せん (a number-changing
        # bug caught in round-5 review: 100本 read as じゅっぽん)
        if 10 in last and (n // 10) % 10 != 0:
            return _num_kana(n)[:-3] + last[10]
        return _num_kana(n) + suffix
    tens = _num_kana(n - u) if n - u else ""
    if u in last:
        return tens + last[u]
    return tens + (_NUM_U[u] if u else "") + suffix


def _month_kana(n: int) -> str:
    return _counted(n, "がつ", {4: "しがつ", 7: "しちがつ", 9: "くがつ"}, {})


def _day_kana(n: int, in_date: bool) -> str:
    # 一日 standalone is the duration いちにち; after ...月 it is the 1st
    if n == 1 and not in_date:
        return "いちにち"
    if n in _DAYS:
        return _DAYS[n]
    return _counted(n, "にち", {}, {})


_NUM_EXPR = r"(?:[0-9０-９]+|[〇一二三四五六七八九十百千万]+)"
_COUNTER_EXPR = "|".join(sorted(map(re.escape, _COUNTERS), key=len,
                                reverse=True))
_DATE_RE = re.compile(f"({_NUM_EXPR})月({_NUM_EXPR})日")
_MONTH_RE = re.compile(f"({_NUM_EXPR}|何)月")
_DAY_RE = re.compile(f"({_NUM_EXPR}|何)日")
_COUNT_RE = re.compile(f"({_NUM_EXPR}|何)({_COUNTER_EXPR})")


def _nan_counted(suffix: str, last: dict) -> str:
    """何+counter reads なん with the same rendaku row as 三 (なんぼん like
    さんぼん, なんぷん like さんぷん): derive the fragment from the
    3-euphonic entry when one exists."""
    if 3 in last and last[3].startswith("さん"):
        return "なん" + last[3][len("さん"):]
    return "なん" + suffix
_BARE_NUM_RE = re.compile(r"[0-9０-９]+")
_BARE_KNUM_RE = re.compile(r"[〇一二三四五六七八九十百千万]{2,}")


_PER_DIGIT = {0: "ぜろ", 1: "いち", 2: "に", 3: "さん", 4: "よん", 5: "ご",
              6: "ろく", 7: "なな", 8: "はち", 9: "きゅう"}


def _arabic_kana(s: str) -> str:
    """Arabic digit run -> kana.  Runs too long for a composed reading
    (IDs, phone numbers) are read digit-by-digit — clamping to the
    representable maximum would speak an unrelated number (round-5 review
    finding)."""
    if len(s) > 8:
        return "".join(
            _PER_DIGIT[int(chr(ord(c) - 0xFEE0)) if "０" <= c <= "９"
                       else int(c)] for c in s)
    return _num_kana(_parse_number(s))


def _match_date(text: str, i: int):
    """Full X月Y日 at position i -> (kana, end) or None.  Tried BEFORE the
    word table: the date reading (一月一日 いちがつついたち) must not be
    split by 一月/一日 word entries."""
    m = _DATE_RE.match(text, i)
    if not m:
        return None
    mo, da = _parse_number(m.group(1)), _parse_number(m.group(2))
    if 1 <= mo <= 12 and 1 <= da <= 31:
        return _month_kana(mo) + _day_kana(da, in_date=True), m.end()
    return None


def _match_number(text: str, i: int):
    """Counter/month/day/bare-number expression at position i ->
    (kana, end) or None.  Tried AFTER the word table so dictionary entries
    win (八百屋 やおや, 十分 じゅうぶん — round-5 review finding: the old
    whole-text regex pass clobbered them)."""
    m = _COUNT_RE.match(text, i)
    if m:
        suffix, last, whole = _COUNTERS[m.group(2)]
        if m.group(1) == "何":
            return _nan_counted(suffix, last), m.end()
        n = _parse_number(m.group(1))
        if n <= 99_999_999:
            return _counted(n, suffix, last, whole), m.end()
    m = _MONTH_RE.match(text, i)
    if m:
        if m.group(1) == "何":
            return "なんがつ", m.end()
        n = _parse_number(m.group(1))
        if 1 <= n <= 12:
            return _month_kana(n), m.end()
    m = _DAY_RE.match(text, i)
    if m:
        if m.group(1) == "何":
            return "なんにち", m.end()
        n = _parse_number(m.group(1))
        if 1 <= n <= 31:
            return _day_kana(n, in_date=False), m.end()
    m = _BARE_NUM_RE.match(text, i)
    if m:
        return _arabic_kana(m.group(0)), m.end()
    # bare MULTI-char kanji numerals get the composed reading with its
    # euphonics (六百 ろっぴゃく); standalone single numerals stay with the
    # word table (十 とお is context-dependent)
    m = _BARE_KNUM_RE.match(text, i)
    if m and _parse_number(m.group(0)) <= 99_999_999:
        return _num_kana(_parse_number(m.group(0))), m.end()
    return None


def _kanji_to_kana(text: str) -> str:
    """Longest-match replacement of kanji(-containing) spans with kana.
    At each position, a full word entry wins; otherwise a conjugation stem
    fires when the following character is a plausible inflection for its
    verb/adjective class (see _STEM_NEXT)."""
    table, stems = _kanji_table()
    text = _particles(text)
    text = _raw_long_vowels(text)
    out: List[str] = []
    i = 0
    n = len(text)
    while i < n:
        # priority: full dates > multi-char word entries > number/counter
        # expressions > conjugation stems > single-char readings.  The
        # number layer sits BELOW the word table (八百屋/十分 keep their
        # dictionary readings) but ABOVE per-char fallback.
        nm = _match_date(text, i)
        if nm:
            # generated kana never carries okurigana, so long-vowelize
            # unconditionally (何名 なんめい -> なんめー like openjtalk)
            out.append(_long_vowelize("", nm[0]))
            i = nm[1]
            continue
        matched = False
        for j in range(min(n, i + 6), i + 1, -1):
            sub = text[i:j]
            if sub in table:
                out.append(_long_vowelize(sub, table[sub]))
                i = j
                matched = True
                break
        if matched:
            continue
        nm = _match_number(text, i)
        if nm:
            out.append(_long_vowelize("", nm[0]))
            i = nm[1]
            continue
        for j in range(min(n, i + 6), i, -1):
            sub = text[i:j]
            # the context-gated stem (we can SEE a valid inflection
            # following) beats the per-char fallback reading
            if sub in stems and j < n and _is_kanji(sub[0]):
                reading, allowed = stems[sub]
                if text[j] in allowed:
                    out.append(reading)
                    i = j
                    matched = True
                    break
            if j - i == 1 and sub in table and "一" <= sub <= "鿿":
                # suffix 中 after a kanji compound reads ちゅう (故障中/
                # 営業中), not the standalone なか.  This runs only when no
                # word entry claimed the span, so 田中/中国 keep their
                # dictionary readings.  Approximate: 一日中 じゅう lands
                # here as ちゅう.
                if (sub == "中" and i > 0 and _is_kanji(text[i - 1])
                        and (j >= n or not _is_kanji(text[j]))):
                    out.append("ちゅう")
                else:
                    out.append(_long_vowelize(sub, table[sub]))
                i = j
                matched = True
                break
        if not matched:
            out.append(text[i])
            i += 1
    return "".join(out)


def g2p(text: str) -> Tuple[List[str], List[int], List[int]]:
    text = text_normalize(text)
    try:
        import pyopenjtalk

        raw = pyopenjtalk.g2p(text).split(" ")
        phones = [p for p in raw if p != "pau"]
        # sokuon/hatsuon fixes (ref japanese.py:19-32) operate on the openjtalk
        # stream: Q -> cl, N stays N
        phones = ["cl" if p == "Q" else p for p in phones]
    except ImportError:
        phones = _kana_to_phones(_kanji_to_kana(text))

    phones = [post_replace_ph(p) for p in phones]
    tones = [0] * len(phones)
    word2ph = [1] * len(phones)
    return phones, tones, word2ph
