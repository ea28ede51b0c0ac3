"""The reference's LM checkpoints (`exp/lm/model_<step>.pt`, HF RoFormer
parts) -> state dicts of the port's `Roformer`.

Counterpart of `latent_diffusion_speech_tpu/models/lm/import_hf.py`, in two
steps as `models/vaegan/import_torch.py` set: `roformer_params_from_torch`
is a numpy copy of the JAX importer (it reads the same keys and builds the
same flax-layout tree), and `roformer_state_from_torch` passes that tree
through `convert.roformer_from_jax`.  So the port reads exactly what JAX
reads: the head bias falls back from `cls.predictions.bias` to
`cls.predictions.decoder.bias`, `spk_emb.weight` is optional, and the tied
`cls.predictions.decoder.weight` (the semantic embeddings again) and HF's
sinusoidal `embed_positions` tables are never read.

The Llama LM is not ported yet: `llama_params_from_torch` raises
`NotImplementedError` (ROADMAP.md Queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from latent_diffusion_speech_tpu_torch.convert import roformer_from_jax

__all__ = ["roformer_params_from_torch", "roformer_state_from_torch", "llama_params_from_torch"]


def _np(v):
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)


def _dense(state, name, bias=True):
    p = {"kernel": _np(state[f"{name}.weight"]).T}
    if bias and f"{name}.bias" in state:
        p["bias"] = _np(state[f"{name}.bias"])
    return p


def _ln(state, name):
    return {"scale": _np(state[f"{name}.weight"]), "bias": _np(state[f"{name}.bias"])}


def _hf_layer(state, prefix, cross: bool) -> Dict:
    out = {
        "self_attn": {
            "query": _dense(state, f"{prefix}.attention.self.query"),
            "key": _dense(state, f"{prefix}.attention.self.key"),
            "value": _dense(state, f"{prefix}.attention.self.value"),
            "out": _dense(state, f"{prefix}.attention.output.dense"),
        },
        "self_ln": _ln(state, f"{prefix}.attention.output.LayerNorm"),
        "ff_in": _dense(state, f"{prefix}.intermediate.dense"),
        "ff_out": _dense(state, f"{prefix}.output.dense"),
        "ff_ln": _ln(state, f"{prefix}.output.LayerNorm"),
    }
    if cross:
        out["cross_attn"] = {
            "query": _dense(state, f"{prefix}.crossattention.self.query"),
            "key": _dense(state, f"{prefix}.crossattention.self.key"),
            "value": _dense(state, f"{prefix}.crossattention.self.value"),
            "out": _dense(state, f"{prefix}.crossattention.output.dense"),
        }
        out["cross_ln"] = _ln(state, f"{prefix}.crossattention.output.LayerNorm")
    return out


def roformer_params_from_torch(state: Dict, cfg) -> Dict:
    """Map the reference `Roformer` state dict (text_encoder.* +
    semantic_decoder.* (+ spk_emb)) onto the flax Roformer tree (numpy)."""
    params: Dict = {
        "phone_embed": {"embedding": _np(state["text_encoder.embeddings.word_embeddings.weight"])},
        "tone_embed": {"embedding": _np(state["text_encoder.embeddings.token_type_embeddings.weight"])},
        "enc_emb_ln": _ln(state, "text_encoder.embeddings.LayerNorm"),
        "semantic_embed": {
            "embedding": _np(state["semantic_decoder.roformer.embeddings.word_embeddings.weight"])
        },
        "dec_type_embed": {
            "embedding": _np(state["semantic_decoder.roformer.embeddings.token_type_embeddings.weight"])
        },
        "dec_emb_ln": _ln(state, "semantic_decoder.roformer.embeddings.LayerNorm"),
        "head_transform": _dense(state, "semantic_decoder.cls.predictions.transform.dense"),
        "head_ln": _ln(state, "semantic_decoder.cls.predictions.transform.LayerNorm"),
        "head_bias": _np(state["semantic_decoder.cls.predictions.bias"])
        if "semantic_decoder.cls.predictions.bias" in state
        else _np(state["semantic_decoder.cls.predictions.decoder.bias"]),
    }
    for i in range(cfg.encoder.num_hidden_layers):
        params[f"enc_{i}"] = _hf_layer(state, f"text_encoder.encoder.layer.{i}", cross=False)
    for i in range(cfg.decoder.num_hidden_layers):
        params[f"dec_{i}"] = _hf_layer(
            state, f"semantic_decoder.roformer.encoder.layer.{i}", cross=True
        )
    if "spk_emb.weight" in state:
        params["spk_embed"] = {"embedding": _np(state["spk_emb.weight"])}
    return params


def roformer_state_from_torch(state: Dict, cfg) -> dict:
    """The reference `Roformer` state dict -> state dict of the port's `Roformer`."""
    return roformer_from_jax(roformer_params_from_torch(state, cfg))


def llama_params_from_torch(state: Dict, cfg) -> Dict:
    """The reference `Llama` state dict: not ported yet."""
    raise NotImplementedError("the Llama LM and its importer are not ported yet (ROADMAP.md Queue 1, item 8)")
