"""BERT-derived text features and tokens (the reference's 'text' LM mode inputs).

Counterpart of `latent_diffusion_speech_tpu/text/bert.py`:

* `get_bert_token(text)`: WordPiece (ids, tokens) for 'text'-mode LM
  training (stage 16), from a local `vocab.txt` (`text/wordpiece.py`);
* `get_bert_feature(norm_text, word2ph)`: phone-level features, the
  tokens' `hidden_states[-3]` rows repeated `word2ph[i]` times and
  transposed to (dim, sum(word2ph)), through the port's BERT /
  MegatronBert encoder (`models/bert.py`).

`NativeBertFeatures` runs on the card unless the caller asks for the CPU.
It reads a local HF checkpoint directory (`config.json` beside a
`pytorch_model*.bin` or `*.safetensors` file) without `transformers`, or
an HF model handed to it.  `get_bert_feature` falls back to the zero mock
(the reference's EN mock) only when the vocabulary or the weights are
missing (`OSError`, `FileNotFoundError` among them); the JAX function
falls back on every exception, which here would also hide a failed CUDA
launch or build, so any other error is raised.  Nothing here imports torch
at module import: stage 16 uses `get_bert_token` on the host alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["get_bert_feature", "get_bert_token", "mock_bert_feature", "NativeBertFeatures"]


def mock_bert_feature(word2ph: List[int], dim: int = 1024) -> np.ndarray:
    """Zero features shaped (dim, sum(word2ph)) (the reference's EN mock)."""
    return np.zeros((dim, int(np.sum(word2ph))), np.float32)


def _find_torch_checkpoint(cache_dir: Optional[str]) -> Optional[Path]:
    if not cache_dir or not Path(cache_dir).exists():
        return None
    for pattern in ("*.safetensors", "pytorch_model*.bin"):
        hits = sorted(Path(cache_dir).rglob(pattern))
        if hits:
            return hits[0]
    return None


def _read_checkpoint(ckpt: Path) -> Tuple[SimpleNamespace, dict]:
    """(HF config attributes, state dict) of a local HF checkpoint file."""
    import torch

    hf_cfg = SimpleNamespace(**json.loads((ckpt.parent / "config.json").read_text(encoding="utf-8")))
    if ckpt.suffix == ".safetensors":
        from safetensors.torch import load_file

        return hf_cfg, load_file(str(ckpt))
    return hf_cfg, torch.load(ckpt, map_location="cpu", weights_only=True)


class NativeBertFeatures:
    """The port's BERT feature extractor bound to local weights (or an HF
    torch model handed in, for tests)."""

    def __init__(self, hf_model=None, cache_dir: Optional[str] = "pretrain", dtype=None, device=None):
        """device: None means `cuda` (raises without a card), resolved before
        any file is read; dtype: the products' dtype (default f32)."""
        import torch

        from latent_diffusion_speech_tpu_torch.convert import bert_from_jax
        from latent_diffusion_speech_tpu_torch.models.bert import (
            BertConfig,
            BertEncoderModel,
            bert_params_from_torch,
        )
        from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, resolve_device

        self.device = resolve_device(device)
        if hf_model is None:
            ckpt = _find_torch_checkpoint(cache_dir)
            if ckpt is None:
                raise FileNotFoundError(f"no local BERT checkpoint under {cache_dir!r}")
            hf_cfg, state = _read_checkpoint(ckpt)
        else:
            hf_cfg, state = hf_model.config, hf_model.state_dict()
        self.cfg = BertConfig.from_hf(hf_cfg)
        model = BertEncoderModel(self.cfg)
        model.load_state_dict(bert_from_jax(bert_params_from_torch(state, self.cfg)))
        self.model = cast_compute_dtype(model, dtype or torch.float32).to(self.device).eval()

    def features(self, token_ids: np.ndarray) -> np.ndarray:
        """(T,) ids -> hidden_states[-3][0] as (T, hidden), f32 numpy."""
        import torch

        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.long, device=self.device)[None]
        with torch.no_grad():
            return self.model(ids)[-3][0].float().cpu().numpy()


def get_bert_token(
    text: str, vocab_file=None, cache_dir: Optional[str] = "pretrain", tokenizer=None
) -> Tuple[np.ndarray, List[str]]:
    """Tokenizer (ids, tokens) for 'text'-mode LM inputs: WordPiece over a
    local vocab.txt (`vocab_file`, else $LDS_BERT_VOCAB, else one under
    `cache_dir`); no HF tokenizer needed."""
    from latent_diffusion_speech_tpu_torch.text.wordpiece import WordPieceTokenizer, find_vocab_file

    if tokenizer is None:
        vocab = Path(vocab_file) if vocab_file else find_vocab_file(cache_dir)
        if vocab is None:
            raise FileNotFoundError(
                "text-mode tokenization needs a BERT vocab.txt: set LDS_BERT_VOCAB, "
                f"pass vocab_file=, or place one under {cache_dir!r}"
            )
        tokenizer = WordPieceTokenizer(vocab)
    ids, tokens = tokenizer.encode(text)
    return np.asarray(ids, np.int64), tokens


def get_bert_feature(
    norm_text: str,
    word2ph: List[int],
    vocab_file=None,
    cache_dir: Optional[str] = "pretrain",
    extractor: Optional[NativeBertFeatures] = None,
    tokenizer=None,
    device=None,
) -> np.ndarray:
    """Phone-level BERT hidden states: tokenize the normalized text, take
    hidden_states[-3], repeat row i word2ph[i] times, return (dim,
    sum(word2ph)).  The zero mock when no local vocabulary or weights exist
    (offline environments); `device` is the extractor's when none is given."""
    try:
        ids, _ = get_bert_token(norm_text, vocab_file=vocab_file, cache_dir=cache_dir, tokenizer=tokenizer)
        ex = extractor if extractor is not None else NativeBertFeatures(cache_dir=cache_dir, device=device)
    except OSError:  # FileNotFoundError included: no vocabulary or weights
        return mock_bert_feature(word2ph)
    feats = ex.features(ids)

    assert len(word2ph) == feats.shape[0], (len(word2ph), feats.shape)
    phone_level = np.concatenate([np.tile(feats[i][None], (n, 1)) for i, n in enumerate(word2ph)], axis=0)
    return phone_level.T
