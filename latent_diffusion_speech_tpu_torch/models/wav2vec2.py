"""wav2vec 2.0 large (XLSR-53) encoder: the XLSR unit encoder.

Counterpart of `latent_diffusion_speech_tpu/models/wav2vec2.py` (the
reference delegates to fairseq, `tools/tools.py:144-163`,
`extract_features()["x"]`): raw 16 kHz audio, normalised by each
utterance's mean and variance (`do_normalize`), -> 7 convolutions each
followed by a channels-last LayerNorm and GELU -> LayerNorm and feature
projection -> grouped positional conv (the last frame dropped for an even
kernel, GELU) -> pre-LN transformer layers ("stable layer norm") -> final
LayerNorm.  HF `Wav2Vec2Model` with `do_stable_layer_norm=True` and
`feat_extract_norm="layer"` computes the same.

The submodules carry the flax tree's names (`convert.wav2vec2_from_jax`).
The importers read an HF `Wav2Vec2Model` state dict and a fairseq
checkpoint's `model` state dict (renamed to HF's names first), as the
JAX importers do.  Mixed precision follows the JAX module: products in
the weights' dtype, norms in f32, the output of the final LayerNorm f32.
Attention is the plain `dot_product_attention` (`impl="xla"`): no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, LayerNorm

__all__ = ["Wav2Vec2Config", "Wav2Vec2Encoder", "wav2vec2_params_from_hf", "wav2vec2_params_from_fairseq",
           "wav2vec2_state_from_torch"]


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    intermediate_size: int = 4096
    num_attention_heads: int = 16
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_normalize: bool = True  # fairseq `normalize=True` for XLSR

    @classmethod
    def from_hf(cls, hf_cfg) -> "Wav2Vec2Config":
        return cls(
            hidden_size=hf_cfg.hidden_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            intermediate_size=hf_cfg.intermediate_size,
            num_attention_heads=hf_cfg.num_attention_heads,
            conv_dim=tuple(hf_cfg.conv_dim),
            conv_kernel=tuple(hf_cfg.conv_kernel),
            conv_stride=tuple(hf_cfg.conv_stride),
            conv_bias=hf_cfg.conv_bias,
            num_conv_pos_embeddings=hf_cfg.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=hf_cfg.num_conv_pos_embedding_groups,
            layer_norm_eps=hf_cfg.layer_norm_eps,
            do_normalize=getattr(hf_cfg, "do_normalize", True),
        )


class _LayerNormConvFE(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.n = len(cfg.conv_dim)
        c_in = 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            setattr(self, f"conv{i}", nn.Conv1d(c_in, c, k, stride=s, bias=cfg.conv_bias))
            setattr(self, f"conv_ln{i}", LayerNorm(c, eps=1e-5))
            c_in = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        for i in range(self.n):
            conv = getattr(self, f"conv{i}")
            h = conv(h.to(conv.weight.dtype)).transpose(1, 2)
            h = F.gelu(getattr(self, f"conv_ln{i}")(h)).transpose(1, 2)
        return h.transpose(1, 2)


class _PosConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.trim = k % 2 == 0
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2).to(self.conv.weight.dtype))
        if self.trim:
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)


class _StableLNLayer(nn.Module):
    """Pre-LN transformer layer (do_stable_layer_norm=True)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        C = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.layer_norm = LayerNorm(C, eps=cfg.layer_norm_eps)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Dense(C, C) for _ in range(4))
        self.final_layer_norm = LayerNorm(C, eps=cfg.layer_norm_eps)
        self.fc1 = Dense(C, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        h = self.layer_norm(x)
        q, k, v = (p(h).reshape(B, T, self.n_heads, C // self.n_heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        x = x + self.out_proj(dot_product_attention(q, k, v).reshape(B, T, C))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class Wav2Vec2Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _LayerNormConvFE(cfg)
        self.fp_layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.fp_projection = Dense(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv_embed = _PosConvEmbedding(cfg)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", _StableLNLayer(cfg))
        self.encoder_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """Raw audio (B, T) 16 kHz -> hidden states (B, ~T // 320, hidden) f32
        (fairseq `extract_features()["x"]`, HF `last_hidden_state`)."""
        if self.cfg.do_normalize:
            wav = wav.float()
            mean = wav.mean(dim=-1, keepdim=True)
            var = wav.var(dim=-1, keepdim=True, unbiased=False)
            wav = (wav - mean) / torch.sqrt(var + 1e-7)
        x = self.fp_projection(self.fp_layer_norm(self.feature_extractor(wav)))
        x = x + self.pos_conv_embed(x)
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.encoder_layer_norm(x)


# -- weight import -------------------------------------------------------------

def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)


def _fold_weight_norm_dim2(g, v):
    """torch weight_norm(dim=2) on a (out, in, k) conv: norm over (out, in)."""
    norm = np.sqrt(np.sum(v**2, axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def wav2vec2_params_from_hf(state: Dict, cfg: Wav2Vec2Config) -> Dict:
    """An HF `Wav2Vec2Model` state dict (stable-layer-norm variant) -> the
    flax `Wav2Vec2Encoder` tree (numpy)."""
    state = {k: _np(v) for k, v in state.items()}

    def dense(name):
        p = {"kernel": state[f"{name}.weight"].T}
        if f"{name}.bias" in state:
            p["bias"] = state[f"{name}.bias"]
        return p

    def ln(name):
        return {"scale": state[f"{name}.weight"], "bias": state[f"{name}.bias"]}

    fe: Dict = {}
    for i in range(len(cfg.conv_dim)):
        b = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": np.transpose(state[f"{b}.conv.weight"], (2, 1, 0))}
        if f"{b}.conv.bias" in state:
            conv["bias"] = state[f"{b}.conv.bias"]
        fe[f"conv{i}"] = conv
        fe[f"conv_ln{i}"] = ln(f"{b}.layer_norm")
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.parametrizations.weight.original0" in state:
        g, v = state[f"{pc}.parametrizations.weight.original0"], state[f"{pc}.parametrizations.weight.original1"]
    else:
        g, v = state[f"{pc}.weight_g"], state[f"{pc}.weight_v"]
    w = _fold_weight_norm_dim2(g, v)
    params: Dict = {
        "feature_extractor": fe,
        "fp_layer_norm": ln("feature_projection.layer_norm"),
        "fp_projection": dense("feature_projection.projection"),
        "pos_conv_embed": {"conv": {"kernel": np.transpose(w, (2, 1, 0)), "bias": state[f"{pc}.bias"]}},
        "encoder_layer_norm": ln("encoder.layer_norm"),
    }
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "layer_norm": ln(f"{b}.layer_norm"),
            "q_proj": dense(f"{b}.attention.q_proj"),
            "k_proj": dense(f"{b}.attention.k_proj"),
            "v_proj": dense(f"{b}.attention.v_proj"),
            "out_proj": dense(f"{b}.attention.out_proj"),
            "final_layer_norm": ln(f"{b}.final_layer_norm"),
            "fc1": dense(f"{b}.feed_forward.intermediate_dense"),
            "fc2": dense(f"{b}.feed_forward.output_dense"),
        }
    return params


# fairseq -> HF names inside an encoder layer
_FAIRSEQ_LAYER = [
    ("self_attn.", "attention."),
    ("self_attn_layer_norm", "layer_norm"),
    ("fc1", "feed_forward.intermediate_dense"),
    ("fc2", "feed_forward.output_dense"),
]


def wav2vec2_params_from_fairseq(state: Dict, cfg: Wav2Vec2Config) -> Dict:
    """A fairseq wav2vec2 `model` state dict (`xlsr_53_56k.pt`) renamed to
    HF's names, then mapped as `wav2vec2_params_from_hf`.  fairseq keeps
    each conv at `feature_extractor.conv_layers.{i}.0` and its LayerNorm at
    `.2.1`; the quantizer and pretraining heads are dropped."""
    out: Dict = {}
    for key, val in state.items():
        if key.startswith(("quantizer", "project_q", "final_proj", "mask_emb", "label_embs", "w2v_encoder.proj")):
            continue
        k = key
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            if rest.startswith("0."):
                k = f"feature_extractor.conv_layers.{i}.conv.{rest[2:]}"
            elif rest.startswith("2.1."):
                k = f"feature_extractor.conv_layers.{i}.layer_norm.{rest[4:]}"
            else:
                continue
        elif k.startswith("encoder.layers."):
            for pat, rep in _FAIRSEQ_LAYER:
                k = k.replace(pat, rep)
        elif k.startswith("encoder.pos_conv.0"):
            k = k.replace("encoder.pos_conv.0", "encoder.pos_conv_embed.conv")
        elif k.startswith("post_extract_proj"):
            k = k.replace("post_extract_proj", "feature_projection.projection")
        elif k.startswith("layer_norm."):
            k = k.replace("layer_norm.", "feature_projection.layer_norm.")
        out[k] = val
    return wav2vec2_params_from_hf(out, cfg)


def wav2vec2_state_from_torch(state: Dict, cfg: Wav2Vec2Config) -> dict:
    """An HF or fairseq (told apart by `post_extract_proj`, as JAX's
    `XLSRUnits` does) wav2vec2 state dict -> state dict of the port's
    `Wav2Vec2Encoder`."""
    from latent_diffusion_speech_tpu_torch.convert import wav2vec2_from_jax

    if any(k.startswith("post_extract_proj") for k in state):
        return wav2vec2_from_jax(wav2vec2_params_from_fairseq(state, cfg))
    return wav2vec2_from_jax(wav2vec2_params_from_hf(state, cfg))
