"""Native BERT tokenizer (BasicTokenizer + WordPiece), no HF dependency.

The port's own copy of `latent_diffusion_speech_tpu/text/wordpiece.py`
(framework-free; `tests/test_torch_bert.py` holds the two to the same ids).
The reference's 'text' LM mode tokenizes raw text with a BERT tokenizer
(`/root/reference/text/chinese_bert.py:24-26` via Erlangshen-MegatronBert,
`multi_language_bert.py` via bert-base-multilingual-cased).  Those
tokenizers are WordPiece; this module implements the algorithm natively so
the text mode runs offline with nothing but a `vocab.txt` file (one token
per line, index = id — the standard BERT vocab format shipped with every
BERT checkpoint).

Algorithm (matches HF `BertTokenizer` semantics):
* basic tokenize: whitespace clean, CJK chars isolated, optional lowercase +
  accent strip, punctuation split;
* WordPiece: greedy longest-prefix match with '##' continuations,
  max 100 chars/word, unmatched words -> [UNK];
* encode: [CLS] tokens [SEP].
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["WordPieceTokenizer", "load_vocab", "find_vocab_file"]


def load_vocab(vocab_file) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    for i, line in enumerate(Path(vocab_file).read_text(encoding="utf-8").splitlines()):
        vocab[line.rstrip("\n")] = i
    return vocab


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_file,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
    ):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_token_id = self.vocab[cls_token]
        self.sep_token_id = self.vocab[sep_token]
        self.pad_token_id = self.vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenizer ------------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _pad_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._pad_cjk(self._clean(text))
        tokens: List[str] = []
        for word in text.split():
            if self.do_lower_case:
                word = word.lower()
                word = "".join(
                    ch for ch in unicodedata.normalize("NFD", word)
                    if unicodedata.category(ch) != "Mn"
                )
            # split on punctuation
            cur: List[str] = []
            for ch in word:
                if _is_punct(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # -- wordpiece ------------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> Tuple[List[int], List[str]]:
        """Returns (ids, tokens) — the reference `get_bert_token` contract
        (ids + convert_ids_to_tokens)."""
        tokens = self.tokenize(text)
        ids = [self.vocab.get(t, self.vocab[self.unk_token]) for t in tokens]
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
            tokens = ["[CLS]"] + tokens + ["[SEP]"]
        return ids, tokens


def find_vocab_file(cache_dir: Optional[str] = "pretrain") -> Optional[Path]:
    """Locate a local BERT vocab.txt: $LDS_BERT_VOCAB, then any vocab.txt
    under cache_dir (the HF cache layout keeps one per snapshot)."""
    import os

    env = os.environ.get("LDS_BERT_VOCAB")
    if env and Path(env).exists():
        return Path(env)
    if cache_dir and Path(cache_dir).exists():
        hits = sorted(Path(cache_dir).rglob("vocab.txt"))
        if hits:
            return hits[0]
    return None
