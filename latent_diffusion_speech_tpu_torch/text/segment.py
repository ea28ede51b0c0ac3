"""Sentence segmentation for long-text TTS.

Counterpart of `latent_diffusion_speech_tpu/text/segment.py` (the port's own
copy, so it loads nothing of the JAX package): split at sentence-final
punctuation, merge short runs up to `max_chars`, and hard-split oversized
remainders at clause punctuation (then raw length) so no piece exceeds the
budget.  Each piece bounds one LM call of `TTSPipeline.tts_long_text` and
of the HTTP server's long-text requests.  Pure host-side text processing.
"""

from __future__ import annotations

from typing import List

__all__ = ["split_sentences"]

# sentence-final punctuation (kept attached to the preceding sentence)
_FINAL = "。！？!?；;…\n"
# clause-level split points for oversized sentences
_CLAUSE = ",，、:：——"


def _hard_split(piece: str, max_chars: int) -> List[str]:
    if len(piece) <= max_chars:
        return [piece]
    # prefer the clause boundary closest to the budget
    best = -1
    for i, ch in enumerate(piece[:max_chars]):
        if ch in _CLAUSE:
            best = i
    if best <= 0:
        best = max_chars - 1
    head, tail = piece[: best + 1], piece[best + 1 :]
    return [head] + (_hard_split(tail, max_chars) if tail else [])


def split_sentences(text: str, max_chars: int = 60) -> List[str]:
    """Split `text` into TTS-sized pieces.

    Rules: break after sentence-final punctuation; greedily merge consecutive
    sentences while the merged piece stays within `max_chars`; pieces still
    longer than the budget split at their last clause boundary (comma/colon),
    falling back to a raw cut.  Whitespace-only pieces are dropped."""
    if not text:
        return []
    sentences: List[str] = []
    cur = []
    for ch in text:
        cur.append(ch)
        if ch in _FINAL:
            sentences.append("".join(cur))
            cur = []
    if cur:
        sentences.append("".join(cur))

    merged: List[str] = []
    for s in sentences:
        if merged and len(merged[-1]) + len(s) <= max_chars:
            merged[-1] += s
        else:
            merged.append(s)

    out: List[str] = []
    for piece in merged:
        for sub in _hard_split(piece, max_chars):
            if sub.strip():
                out.append(sub.strip("\n"))
    return out
