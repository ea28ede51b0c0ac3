"""BERT / MegatronBert text encoders in PyTorch (the 'text' LM mode features).

Counterpart of `latent_diffusion_speech_tpu/models/bert.py`.  The reference
takes `hidden_states[-3]` of a pretrained BERT (Erlangshen-MegatronBert-1.3B
for ZH, bert-base-multilingual-cased otherwise) as phone-level text
features.  Both layouts:

* classic BERT (post-LN): an embedding LayerNorm; residual then LayerNorm
  around attention and the feed-forward;
* MegatronBert (pre-LN, `pre_ln`): no embedding LayerNorm; a LayerNorm
  before attention and the feed-forward, the residual outside, one final
  LayerNorm after the stack.

`hidden_states` is in HF's order (`output_hidden_states=True`):
[embeddings, layer_1, ..., layer_{L-1}, final], so index -3 is the tensor
the reference reads.  Submodule names follow the flax tree (`layer_0.attn.query`,
`emb_ln`, ...), so `convert.bert_from_jax` maps one onto the other; the
products run in the dtype `ops/layers.py::cast_compute_dtype` gives them,
LayerNorms and embeddings in f32, as the JAX modules with `dtype`.

`bert_params_from_torch` is a numpy copy of the JAX importer (HF
`BertModel` / `MegatronBertModel` state dicts, with or without a `bert.`
prefix); `BertConfig.from_hf` reads any object with HF's attribute names,
so nothing here imports `transformers`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.layers import Dense, LayerNorm

__all__ = ["BertConfig", "BertEncoderModel", "bert_params_from_torch"]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 119547          # bert-base-multilingual-cased
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pre_ln: bool = False              # True = MegatronBert layout

    @classmethod
    def from_hf(cls, hf_cfg) -> "BertConfig":
        return cls(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            num_attention_heads=hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            type_vocab_size=hf_cfg.type_vocab_size,
            layer_norm_eps=hf_cfg.layer_norm_eps,
            pre_ln=hf_cfg.model_type == "megatron-bert",
        )


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        C = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query, self.key, self.value, self.out = (Dense(C, C) for _ in range(4))

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, C = x.shape
        H, D = self.heads, C // self.heads
        q = self.query(x).reshape(B, T, H, D)
        k = self.key(x).reshape(B, T, H, D)
        v = self.value(x).reshape(B, T, H, D)
        # JAX divides by sqrt(D) in x's dtype (f32: LayerNorm and embedding
        # outputs), so from there on the scores, probabilities and their
        # product with v are f32 even when the projections run in bf16
        dt = torch.promote_types(q.dtype, x.dtype)
        scores = torch.einsum("blhd,brhd->bhlr", q, k).to(dt) / D ** 0.5
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhlr,brhd->blhd", probs, v.to(probs.dtype))
        return self.out(out.reshape(B, T, C))


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pre_ln = cfg.pre_ln
        self.attn = _SelfAttention(cfg)
        self.attn_ln = LayerNorm(C, eps)
        self.ffn_in = Dense(C, cfg.intermediate_size)
        self.ffn_out = Dense(cfg.intermediate_size, C)
        self.ffn_ln = LayerNorm(C, eps)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.attn(self.attn_ln(x), mask_bias)
            return x + self.ffn_out(F.gelu(self.ffn_in(self.ffn_ln(x))))
        x = self.attn_ln(x + self.attn(x, mask_bias))
        return self.ffn_ln(x + self.ffn_out(F.gelu(self.ffn_in(x))))


class BertEncoderModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        C = cfg.hidden_size
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, C)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, C)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, C)
        if cfg.pre_ln:
            self.final_ln = LayerNorm(C, cfg.layer_norm_eps)
        else:
            self.emb_ln = LayerNorm(C, cfg.layer_norm_eps)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", _Layer(cfg))

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Returns the HF-ordered hidden_states (layers + 1 tensors, f32)."""
        cfg = self.cfg
        T = input_ids.shape[1]
        types = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(torch.arange(T, device=input_ids.device))[None]
             + self.token_type_embeddings(types))
        if not cfg.pre_ln:
            x = self.emb_ln(x)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -1e9
        hidden = [x]
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, mask_bias)
            hidden.append(x)
        if cfg.pre_ln:
            # MegatronBert: the final LayerNorm replaces the last raw layer
            # output in HF's hidden_states
            hidden[-1] = self.final_ln(x)
        return hidden


# ---------------------------------------------------------------------------
# HF import (BertModel or MegatronBertModel state dicts)
# ---------------------------------------------------------------------------

def _np(v):
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v)


def bert_params_from_torch(state: Dict, cfg: BertConfig) -> Dict:
    """An HF BERT / MegatronBert state dict -> the flax BertEncoderModel tree
    (numpy); `convert.bert_from_jax` turns it into the port's state dict."""
    state = {k.removeprefix("bert."): v for k, v in state.items()}

    def dense(name):
        return {"kernel": _np(state[f"{name}.weight"]).T, "bias": _np(state[f"{name}.bias"])}

    def ln(name):
        return {"scale": _np(state[f"{name}.weight"]), "bias": _np(state[f"{name}.bias"])}

    def emb(name):
        return {"embedding": _np(state[f"{name}.weight"])}

    params: Dict = {
        "word_embeddings": emb("embeddings.word_embeddings"),
        "position_embeddings": emb("embeddings.position_embeddings"),
        "token_type_embeddings": emb("embeddings.token_type_embeddings"),
    }
    if cfg.pre_ln:
        params["final_ln"] = ln("encoder.ln")
    else:
        params["emb_ln"] = ln("embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}"
        layer = {
            "attn": {
                "query": dense(f"{b}.attention.self.query"),
                "key": dense(f"{b}.attention.self.key"),
                "value": dense(f"{b}.attention.self.value"),
                "out": dense(f"{b}.attention.output.dense"),
            },
            "ffn_in": dense(f"{b}.intermediate.dense"),
            "ffn_out": dense(f"{b}.output.dense"),
        }
        if cfg.pre_ln:
            layer["attn_ln"] = ln(f"{b}.attention.ln")
            layer["ffn_ln"] = ln(f"{b}.ln")
        else:
            layer["attn_ln"] = ln(f"{b}.attention.output.LayerNorm")
            layer["ffn_ln"] = ln(f"{b}.output.LayerNorm")
        params[f"layer_{i}"] = layer
    return params
