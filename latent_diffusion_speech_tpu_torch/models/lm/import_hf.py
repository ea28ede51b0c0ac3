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

The reference's `Llama` checkpoints (HF `LlamaForCausalLM` parts under a
`llama.` prefix, or bare) go the same way: `llama_params_from_torch` is a
numpy copy of the JAX importer and `llama_state_from_torch` passes its tree
through `convert.llama_from_jax`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from latent_diffusion_speech_tpu_torch.convert import llama_from_jax, roformer_from_jax

__all__ = ["roformer_params_from_torch", "roformer_state_from_torch", "llama_params_from_torch",
           "llama_state_from_torch"]


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
    """Map the reference `Llama` state dict (llama.model.* / llama.lm_head,
    or the same keys bare) onto the flax Llama tree (numpy)."""
    pre = "llama." if any(k.startswith("llama.") for k in state) else ""
    params: Dict = {
        "embed_tokens": {"embedding": _np(state[f"{pre}model.embed_tokens.weight"])},
        "final_ln": {"scale": _np(state[f"{pre}model.norm.weight"])},
        "lm_head": {"kernel": _np(state[f"{pre}lm_head.weight"]).T},
    }
    for i in range(cfg.num_hidden_layers):
        b = f"{pre}model.layers.{i}"
        params[f"block_{i}"] = {
            "input_ln": {"scale": _np(state[f"{b}.input_layernorm.weight"])},
            "post_ln": {"scale": _np(state[f"{b}.post_attention_layernorm.weight"])},
            "q_proj": _dense(state, f"{b}.self_attn.q_proj", bias=False),
            "k_proj": _dense(state, f"{b}.self_attn.k_proj", bias=False),
            "v_proj": _dense(state, f"{b}.self_attn.v_proj", bias=False),
            "o_proj": _dense(state, f"{b}.self_attn.o_proj", bias=False),
            "gate_proj": _dense(state, f"{b}.mlp.gate_proj", bias=False),
            "up_proj": _dense(state, f"{b}.mlp.up_proj", bias=False),
            "down_proj": _dense(state, f"{b}.mlp.down_proj", bias=False),
        }
    return params


def llama_state_from_torch(state: Dict, cfg) -> dict:
    """The reference `Llama` state dict -> state dict of the port's `Llama`."""
    return llama_from_jax(llama_params_from_torch(state, cfg))
