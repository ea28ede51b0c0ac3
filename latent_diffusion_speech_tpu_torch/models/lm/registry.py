"""LM registry: build the configured text->semantic language model.

Counterpart of `latent_diffusion_speech_tpu/models/lm/registry.py`, with
`roformer_config_from` and `llama_config_from` (JAX
`train/lm_trainer.py::roformer_config_from` / `llama_config_from`, which the
port's LM trainer imports from here).  `type: roformer` builds a
`RoformerSystem`, `type: llama` a `LlamaSystem` (one device: no mesh).
"""

from __future__ import annotations

import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig

__all__ = ["get_language_model", "roformer_config_from", "llama_config_from"]


def roformer_config_from(cfg: Config) -> RoformerConfig:
    m = cfg.text2semantic.model

    def stack(tc) -> StackConfig:
        return StackConfig(
            hidden_size=tc.hidden_size,
            num_attention_heads=tc.num_attention_heads,
            num_hidden_layers=tc.num_hidden_layers,
            intermediate_size=tc.intermediate_size,
            layer_norm_eps=tc.layer_norm_eps,
            hidden_dropout_prob=tc.hidden_dropout_prob,
            attention_probs_dropout_prob=tc.attention_probs_dropout_prob,
            max_position_embeddings=tc.max_position_embeddings,
        )

    return RoformerConfig(
        encoder=stack(m.encoder),
        decoder=stack(m.decoder),
        mode="phone",  # text mode requires an external BERT tokenizer vocab
        semantic_kmeans_num=m.semantic_kmeans_num,
        n_spk=cfg.common.n_spk,
    )


def llama_config_from(cfg: Config) -> LlamaConfig:
    """Decoder-only Llama geometry from the config's `decoder` stack and the
    MoE fields (the JAX package's mapping)."""
    m = cfg.text2semantic.model
    tc = m.decoder
    return LlamaConfig(
        hidden_size=tc.hidden_size,
        num_attention_heads=tc.num_attention_heads,
        num_hidden_layers=tc.num_hidden_layers,
        intermediate_size=tc.intermediate_size,
        mode="phone",
        semantic_kmeans_num=m.semantic_kmeans_num,
        moe_experts=m.moe_experts,
        moe_top_k=m.moe_top_k,
        moe_capacity_factor=m.moe_capacity_factor,
        moe_aux_weight=m.moe_aux_weight,
    )


def get_language_model(cfg: Config, dtype=None, seed: int = 0, device=None, state_dict=None):
    """The configured LM system (dtype None means f32; device None means
    `cuda`): the weights of `state_dict` (an f32 state dict of the LM
    trainer's checkpoint) cast to `dtype`, else seeded ones.  The JAX
    function's `codebook` warm start of the semantic embeddings (the LM
    trainer passes it to the system itself) and its `mesh` (the Llama's
    expert sharding) are not taken here."""
    dtype = dtype or torch.float32
    mtype = cfg.text2semantic.model.type
    if mtype == "roformer":
        return RoformerSystem(roformer_config_from(cfg), state_dict=state_dict, dtype=dtype, device=device,
                              seed=seed)
    if mtype == "llama":
        return LlamaSystem(llama_config_from(cfg), state_dict=state_dict, dtype=dtype, device=device, seed=seed)
    raise ValueError(f"[x] Unknown language model type: {mtype}")
