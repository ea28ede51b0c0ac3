"""HuBERT (bshall's release) as a unit encoder.

Counterpart of `latent_diffusion_speech_tpu/models/hubert.py` (the
reference's alternative unit encoder, `encoder/hubert/model.py:19-228`):
a 7-conv feature extractor (no padding, GroupNorm of 512 groups after the
first conv, exact GELU), LayerNorm and a 512 -> 768 projection, a grouped
positional conv (kernel 128, 16 groups, padding 64, the last frame dropped,
GELU), LayerNorm, 12 post-LN encoder layers (torch.nn.TransformerEncoderLayer
with `norm_first=False`: 12 heads, separate q/k/v, 3072 exact-GELU FF) and a
768 -> 256 unit projection.  `HubertSoft.units` pads the 16 kHz input by
(400 - 320) // 2 samples on each side: 50 fps 256-d soft units.  The width
is fixed (about 95 M parameters).  `compute_span_mask` and `logits` are the
training head (SpecAugment spans, cosine similarity to the label embeddings
over 0.1).

The submodules carry the flax tree's names, so `convert.hubert_from_jax`
maps by leaf and `hubert_state_from_torch` reads bshall's checkpoint (a
`hubert` or `model` key, packed `in_proj` q/k/v, a weight-normed
positional conv) through `hubert_params_from_torch`.  Mixed precision
follows the JAX module: products in the weights' dtype (`cast_compute_dtype`),
norms in f32, each layer's output cast back, the units in the weights'
dtype.  Attention is the plain `dot_product_attention` (`impl="xla"`), as in
JAX: no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, GroupNorm, LayerNorm

__all__ = ["Hubert", "HubertSoft", "compute_span_mask", "hubert_params_from_torch", "hubert_state_from_torch"]

_CONVS = [(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]


class FeatureExtractor(nn.Module):
    """Raw audio (B, T) -> (B, T // 320, 512), unpadded convolutions."""

    def __init__(self):
        super().__init__()
        for i, (k, s) in enumerate(_CONVS):
            setattr(self, f"conv{i}", nn.Conv1d(1 if i == 0 else 512, 512, k, stride=s, bias=False))
        self.norm0 = GroupNorm(512, 512, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        for i in range(len(_CONVS)):
            conv = getattr(self, f"conv{i}")
            h = conv(h.to(conv.weight.dtype))
            if i == 0:
                h = self.norm0(h.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(h)
        return h.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(768, 768, 128, padding=64, groups=16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2).to(self.conv.weight.dtype))
        return F.gelu(h[:, :, :-1]).transpose(1, 2)


class EncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer semantics (post-LN)."""

    def __init__(self, n_heads: int = 12, d_model: int = 768, d_ff: int = 3072):
        super().__init__()
        self.n_heads = n_heads
        self.q, self.k, self.v, self.out = (Dense(d_model, d_model) for _ in range(4))
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ff1 = Dense(d_model, d_ff)
        self.ff2 = Dense(d_ff, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        dtype = self.q.weight.dtype
        q, k, v = (p(x).reshape(B, T, self.n_heads, C // self.n_heads) for p in (self.q, self.k, self.v))
        attn = self.out(dot_product_attention(q, k, v).reshape(B, T, C))
        x = self.norm1(x + attn).to(dtype)
        h = self.ff2(F.gelu(self.ff1(x)))
        return self.norm2(x + h).to(dtype)


def compute_span_mask(generator: torch.Generator, shape: Tuple[int, int], mask_prob: float = 0.8,
                      mask_length: int = 10, min_masks: int = 2) -> torch.Tensor:
    """SpecAugment span mask (ref `_compute_mask`, model.py:176-228): per
    row, max(prob * T / len, min_masks) spans of `mask_length` frames from
    starts drawn uniformly in [0, T - len) from `generator` (on its device)."""
    B, T = shape
    num_spans = max(int(mask_prob * T / mask_length), min_masks)
    starts = torch.randint(0, max(T - mask_length, 1), (B, num_spans), generator=generator,
                           device=generator.device)
    idx = (starts[..., None] + torch.arange(mask_length, device=starts.device)).reshape(B, -1)
    mask = torch.zeros((B, T), dtype=torch.bool, device=starts.device)
    # JAX's scatter drops indices past the end; so does this
    keep = idx < T
    rows = torch.arange(B, device=starts.device)[:, None].expand_as(idx)
    mask[rows[keep], idx[keep]] = True
    return mask


class Hubert(nn.Module):
    def __init__(self, num_label_embeddings: int = 100):
        super().__init__()
        self.feature_extractor = FeatureExtractor()
        self.fp_norm = LayerNorm(512, eps=1e-5)
        self.fp_proj = Dense(512, 768)
        self.positional_embedding = PositionalConvEmbedding()
        self.norm = LayerNorm(768, eps=1e-5)
        for i in range(12):
            setattr(self, f"layer_{i}", EncoderLayer())
        self.proj = Dense(768, 256)
        self.masked_spec_embed = nn.Parameter(torch.empty(768))
        self.label_embedding = nn.Embedding(num_label_embeddings, 256)

    def encode(self, wav: torch.Tensor, layer: Optional[int] = None,
               span_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fp_proj(self.fp_norm(self.feature_extractor(wav)))
        if span_mask is not None:
            x = torch.where(span_mask[..., None], self.masked_spec_embed.to(x.dtype), x)
        x = self.norm(x + self.positional_embedding(x))
        for i in range(layer if layer is not None else 12):
            x = getattr(self, f"layer_{i}")(x)
        return x

    def logits(self, units: torch.Tensor) -> torch.Tensor:
        """Cosine similarity to the label embeddings over 0.1 (ref model.py:57-63)."""
        u = units / units.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        e = self.label_embedding.weight
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return (u @ e.T.to(u.dtype)) / 0.1

    def forward(self, wav: torch.Tensor, span_mask: Optional[torch.Tensor] = None):
        units = self.proj(self.encode(wav, span_mask=span_mask))
        return self.logits(units), units


class HubertSoft(Hubert):
    def units(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) 16 kHz -> (B, T // 320, 256) soft units (ref model.py:72-80)."""
        pad = (400 - 320) // 2
        return self.proj(self.encode(F.pad(wav, (pad, pad))))


# -- bshall's checkpoint (TransformerEncoderLayer packs q/k/v in in_proj) ----

def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)


def hubert_params_from_torch(state: Dict) -> Dict:
    """bshall's `Hubert` state dict -> the flax `Hubert` tree (numpy), as
    the JAX importer maps it: `in_proj` split into q, k, v; the positional
    conv's weight norm (dim 2: the norm over (out, in) per tap) folded."""
    state = {k: _np(v) for k, v in state.items()}

    def dense(name):
        p = {"kernel": state[f"{name}.weight"].T}
        if f"{name}.bias" in state:
            p["bias"] = state[f"{name}.bias"]
        return p

    def ln(name):
        return {"scale": state[f"{name}.weight"], "bias": state[f"{name}.bias"]}

    fe = {f"conv{i}": {"kernel": np.transpose(state[f"feature_extractor.conv{i}.weight"], (2, 1, 0))}
          for i in range(7)}
    fe["norm0"] = ln("feature_extractor.norm0")
    pe = "positional_embedding.conv"
    if f"{pe}.parametrizations.weight.original0" in state:
        g, v = state[f"{pe}.parametrizations.weight.original0"], state[f"{pe}.parametrizations.weight.original1"]
    else:
        g, v = state[f"{pe}.weight_g"], state[f"{pe}.weight_v"]
    w = g * v / np.maximum(np.sqrt(np.sum(v**2, axis=(0, 1), keepdims=True)), 1e-12)
    params: Dict = {
        "feature_extractor": fe,
        "fp_norm": ln("feature_projection.norm"),
        "fp_proj": dense("feature_projection.projection"),
        "positional_embedding": {"conv": {"kernel": np.transpose(w, (2, 1, 0)), "bias": state[f"{pe}.bias"]}},
        "norm": ln("norm"),
        "proj": dense("proj"),
        "masked_spec_embed": state["masked_spec_embed"],
        "label_embedding": {"embedding": state["label_embedding.weight"]},
    }
    for i in range(12):
        b = f"encoder.layers.{i}"
        in_w, in_b = state[f"{b}.self_attn.in_proj_weight"], state[f"{b}.self_attn.in_proj_bias"]
        C = in_w.shape[1]
        params[f"layer_{i}"] = {
            "q": {"kernel": in_w[:C].T, "bias": in_b[:C]},
            "k": {"kernel": in_w[C : 2 * C].T, "bias": in_b[C : 2 * C]},
            "v": {"kernel": in_w[2 * C :].T, "bias": in_b[2 * C :]},
            "out": dense(f"{b}.self_attn.out_proj"),
            "norm1": ln(f"{b}.norm1"),
            "norm2": ln(f"{b}.norm2"),
            "ff1": dense(f"{b}.linear1"),
            "ff2": dense(f"{b}.linear2"),
        }
    return params


def hubert_state_from_torch(state: Dict) -> dict:
    """bshall's `Hubert` state dict -> state dict of the port's `Hubert`."""
    from latent_diffusion_speech_tpu_torch.convert import hubert_from_jax

    return hubert_from_jax(hubert_params_from_torch(state))
