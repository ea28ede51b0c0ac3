"""The port's copy of the text frontend (`latent_diffusion_speech_tpu_torch/text/`)
against the JAX package's: the same sentences give the same phone, tone and
language id sequences (exact)."""

import importlib

import pytest

from latent_diffusion_speech_tpu.text import text_to_sequence as j_text_to_sequence
from latent_diffusion_speech_tpu_torch.text import text_to_sequence

SENTENCES = [
    ("EN", "The quick brown fox jumps over the lazy dog, and then it runs back home."),
    ("EN", "Hello world, this is a test of the speech system."),
    ("EN", "On 12 May 2021, 3 engineers paid $45.50 for zyxquorb widgets!"),
    ("JA", "こんにちは、今日はいい天気ですね。"),
    ("JA", "私は東京に住んでいます。"),
    ("JA", "カタカナとひらがな、そして漢字。"),
]


@pytest.mark.parametrize("language,text", SENTENCES)
def test_text_to_sequence_matches_jax_package(language, text):
    assert text_to_sequence(text, language) == j_text_to_sequence(text, language)


def test_symbol_table_matches_jax_package():
    # the packages re-export a `symbols` list under the module's name
    port_symbols = importlib.import_module("latent_diffusion_speech_tpu_torch.text.symbols")
    j_symbols = importlib.import_module("latent_diffusion_speech_tpu.text.symbols")
    assert port_symbols.symbols == j_symbols.symbols
    assert port_symbols.language_tone_start_map == j_symbols.language_tone_start_map
