"""LM registry: build the configured text->semantic language model.

Counterpart of `latent_diffusion_speech_tpu/models/lm/registry.py`.  It
keeps its own copy of `roformer_config_from` (JAX
`train/lm_trainer.py::roformer_config_from`), since the LM trainer is not
ported.  `type: roformer` builds a `RoformerSystem`; `type: llama` raises
`NotImplementedError` until the Llama LM is ported (ROADMAP.md Queue 1,
item 8).
"""

from __future__ import annotations

import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig

__all__ = ["get_language_model", "roformer_config_from"]


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


def get_language_model(cfg: Config, dtype=None, seed: int = 0, device=None):
    """The configured LM system with seeded weights (dtype None means f32;
    device None means `cuda`).  The JAX function's `codebook` warm start of
    the semantic embeddings and its `mesh` (Llama MoE) are not ported."""
    dtype = dtype or torch.float32
    mtype = cfg.text2semantic.model.type
    if mtype == "roformer":
        return RoformerSystem(roformer_config_from(cfg), dtype=dtype, device=device, seed=seed)
    if mtype == "llama":
        raise NotImplementedError("the Llama LM is not ported yet (ROADMAP.md Queue 1, item 8)")
    raise ValueError(f"[x] Unknown language model type: {mtype}")
