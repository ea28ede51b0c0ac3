"""Text frontend (L4): symbols, sequence encoding, per-language G2P dispatch.

The port's own copy of `latent_diffusion_speech_tpu/text/` (without the BERT
feature modules), so the port loads nothing of the JAX package; the data
tables in `data/` are copies too.  `tests/test_torch_text.py` holds the two
frontends to the same sequences.

Parity surface with the reference `text/` package (`text/__init__.py:6-18`,
`text/cleaner.py:10-24`).  Heavy G2P dependencies (pypinyin, g2p_en,
pyopenjtalk) are optional: each language module degrades to a clearly-reported
error if its dependency is missing, while the symbol/sequence layer is pure.
"""

from __future__ import annotations

from typing import List, Tuple

from latent_diffusion_speech_tpu_torch.text.symbols import (  # noqa: F401
    language_id_map,
    language_tone_start_map,
    num_languages,
    num_tones,
    pad_id,
    sil_phonemes_ids,
    symbols,
)

_symbol_to_id = {s: i for i, s in enumerate(symbols)}


def cleaned_text_to_sequence(
    cleaned_text: List[str], tones: List[int], language: str
) -> Tuple[List[int], List[int], List[int]]:
    """Phoneme strings -> (phone ids, language-shifted tones, language ids)."""
    phones = [_symbol_to_id[s] for s in cleaned_text]
    tone_start = language_tone_start_map[language]
    tones = [t + tone_start for t in tones]
    lang_id = language_id_map[language]
    return phones, tones, [lang_id] * len(phones)


def clean_text(text: str, language: str):
    """Normalize + G2P for one language. Returns (norm_text, phones, tones, word2ph)."""
    module = _language_module(language)
    norm_text = module.text_normalize(text)
    phones, tones, word2ph = module.g2p(norm_text)
    return norm_text, phones, tones, word2ph


def text_to_sequence(text: str, language: str):
    """Reference `text_to_sequence` (`cleaner.py:22-24`):
    returns ((phones, tones, lang_ids), (norm_text, word2ph))."""
    norm_text, phones, tones, word2ph = clean_text(text, language)
    return cleaned_text_to_sequence(phones, tones, language), (norm_text, word2ph)


def _language_module(language: str):
    if language == "ZH":
        from latent_diffusion_speech_tpu_torch.text import chinese

        return chinese
    if language == "EN":
        from latent_diffusion_speech_tpu_torch.text import english

        return english
    if language == "JA":
        from latent_diffusion_speech_tpu_torch.text import japanese

        return japanese
    raise ValueError(f"unsupported language: {language!r}")
