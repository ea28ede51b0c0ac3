"""w2v-BERT 2.0: the Kaldi fbank frontend and the conformer encoder.

Counterpart of `latent_diffusion_speech_tpu/models/w2vbert.py` (the
reference delegates to HF's facebook/w2v-bert-2.0, `tools/tools.py:128-142`):
* `w2vbert_fbank` (SeamlessM4TFeatureExtractor's semantics): x 2^15, 400-sample
  frames at hop 160 (no centring, no dither), each frame's mean removed,
  pre-emphasis 0.97 (the first sample scaled by 0.03), a Povey window
  (Hann^0.85), the 512-point power spectrum, 80 Kaldi mel filters
  (`kaldi_mel_filters`, triangular in mel space), log with a floor of
  2^-23, each mel bin normalised over time (variance with ddof 1), and two
  frames stacked into one 160-d input: 50 fps.  It runs in f32 on the
  input's device whatever the encoder's dtype.
* `W2vBertModel`: LayerNorm and projection, then conformer blocks: a
  half-step FFN (swish), self-attention with a learned relative-key bias
  (distances clipped to [-64, 8]), the convolution module (LayerNorm,
  pointwise to 2h, GLU, causal depthwise conv of 31 taps, LayerNorm, swish,
  pointwise), a second half-step FFN, and a final LayerNorm.

The submodules carry the flax tree's names (`convert.w2vbert_from_jax`); the
pointwise convolutions are `Dense` layers, as in JAX.  `w2vbert_params_from_torch`
reads an HF `Wav2Vec2BertModel` state dict.  Mixed precision follows the
JAX module: products (attention scores included) in the weights' dtype,
the softmax and the norms in f32, each block's output f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.layers import Dense, LayerNorm

__all__ = ["W2vBertConfig", "kaldi_mel_filters", "w2vbert_fbank", "W2vBertModel", "w2vbert_params_from_torch",
           "w2vbert_state_from_torch"]


@dataclass(frozen=True)
class W2vBertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    intermediate_size: int = 4096
    num_attention_heads: int = 16
    feature_projection_input_dim: int = 160
    layer_norm_eps: float = 1e-5
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31

    @classmethod
    def from_hf(cls, hf_cfg) -> "W2vBertConfig":
        return cls(
            hidden_size=hf_cfg.hidden_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            intermediate_size=hf_cfg.intermediate_size,
            num_attention_heads=hf_cfg.num_attention_heads,
            feature_projection_input_dim=hf_cfg.feature_projection_input_dim,
            layer_norm_eps=hf_cfg.layer_norm_eps,
            left_max_position_embeddings=hf_cfg.left_max_position_embeddings,
            right_max_position_embeddings=hf_cfg.right_max_position_embeddings,
            conv_depthwise_kernel_size=hf_cfg.conv_depthwise_kernel_size,
        )


# -- fbank frontend ------------------------------------------------------------

def _hz_to_mel_kaldi(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def kaldi_mel_filters(
    num_frequency_bins: int = 257,
    num_mel_filters: int = 80,
    min_frequency: float = 20.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = 16000,
) -> np.ndarray:
    """Kaldi mel filters triangular in mel space (HF `mel_filter_bank(...,
    mel_scale='kaldi', triangularize_in_mel_space=True, norm=None)`):
    (num_frequency_bins, num_mel_filters) float64."""
    mel_freqs = np.linspace(_hz_to_mel_kaldi(min_frequency), _hz_to_mel_kaldi(max_frequency), num_mel_filters + 2)
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_freqs = _hz_to_mel_kaldi(fft_bin_width * np.arange(num_frequency_bins))
    fdiff = np.diff(mel_freqs)
    slopes = mel_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def w2vbert_fbank(audio: torch.Tensor, mel_filters: Optional[np.ndarray] = None, stride: int = 2) -> torch.Tensor:
    """16 kHz audio (B, T) -> stacked log-mel features (B, T // 320, 160), f32."""
    if audio.dim() == 1:
        audio = audio[None]
    frame_length, hop, fft_length = 400, 160, 512
    dev = audio.device
    filters = torch.as_tensor(mel_filters if mel_filters is not None else kaldi_mel_filters(),
                              dtype=torch.float32, device=dev)
    window = torch.as_tensor(np.power(np.hanning(frame_length), 0.85), dtype=torch.float32, device=dev)

    frames = (audio.float() * 32768.0).unfold(-1, frame_length, hop)  # (B, F, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - 0.97), frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    spec = torch.fft.rfft(frames * window, n=fft_length, dim=-1).abs() ** 2
    mel = torch.log(torch.clamp_min(spec @ filters, 1.192092955078125e-07))  # (B, F, 80)
    n = mel.shape[1]
    mean = mel.mean(dim=1, keepdim=True)
    var = mel.var(dim=1, keepdim=True, unbiased=False) * n / max(n - 1, 1)
    mel = (mel - mean) / torch.sqrt(var + 1e-7)
    keep = (n // stride) * stride
    return mel[:, :keep].reshape(mel.shape[0], keep // stride, stride * mel.shape[-1])


# -- conformer encoder -----------------------------------------------------------

class _FeedForward(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.intermediate_dense = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class _RelKeySelfAttention(nn.Module):
    """Self-attention with a learned relative-position key bias
    (position_embeddings_type='relative_key')."""

    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        C = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.left, self.right = cfg.left_max_position_embeddings, cfg.right_max_position_embeddings
        self.linear_q, self.linear_k, self.linear_v, self.linear_out = (Dense(C, C) for _ in range(4))
        self.distance_embedding = nn.Parameter(torch.empty(self.left + self.right + 1, C // self.n_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H, D = self.n_heads, C // self.n_heads
        dtype = self.linear_q.weight.dtype
        q, k, v = (p(x).reshape(B, T, H, D) for p in (self.linear_q, self.linear_k, self.linear_v))
        inv = torch.tensor(D ** 0.5, dtype=dtype)  # JAX divides by sqrt(D) in the compute dtype
        scores = torch.einsum("blhd,brhd->bhlr", q, k) / inv
        pos_idx = torch.arange(T, device=x.device)
        distance = torch.clamp(pos_idx[None, :] - pos_idx[:, None], -self.left, self.right)
        pos = self.distance_embedding[distance + self.left].to(dtype)  # (T, T, D)
        scores = scores + torch.einsum("blhd,lrd->bhlr", q, pos) / inv
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        out = torch.einsum("bhlr,brhd->blhd", probs, v).reshape(B, T, C)
        return self.linear_out(out)


class _ConvModule(nn.Module):
    """LayerNorm -> pointwise (2h) -> GLU -> causal depthwise conv (k) ->
    LayerNorm -> swish -> pointwise (h)."""

    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        C, k = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.k = k
        self.layer_norm = LayerNorm(C, eps=cfg.layer_norm_eps)
        self.pointwise_conv1 = Dense(C, 2 * C, bias=False)
        self.depthwise_conv = nn.Conv1d(C, C, k, groups=C, bias=False)
        self.depthwise_layer_norm = LayerNorm(C, eps=cfg.layer_norm_eps)
        self.pointwise_conv2 = Dense(C, C, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise_conv1(self.layer_norm(x)).chunk(2, dim=-1)
        h = (a * torch.sigmoid(b)).transpose(1, 2)
        h = self.depthwise_conv(F.pad(h, (self.k - 1, 0)).to(self.depthwise_conv.weight.dtype)).transpose(1, 2)
        return self.pointwise_conv2(F.silu(self.depthwise_layer_norm(h)))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        C = cfg.hidden_size
        self.ffn1_layer_norm, self.ffn1 = LayerNorm(C, eps=eps), _FeedForward(cfg)
        self.self_attn_layer_norm, self.self_attn = LayerNorm(C, eps=eps), _RelKeySelfAttention(cfg)
        self.conv_module = _ConvModule(cfg)
        self.ffn2_layer_norm, self.ffn2 = LayerNorm(C, eps=eps), _FeedForward(cfg)
        self.final_layer_norm = LayerNorm(C, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x))
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        x = x + self.conv_module(x)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class W2vBertModel(nn.Module):
    def __init__(self, cfg: W2vBertConfig):
        super().__init__()
        self.cfg = cfg
        self.fp_layer_norm = LayerNorm(cfg.feature_projection_input_dim, eps=cfg.layer_norm_eps)
        self.fp_projection = Dense(cfg.feature_projection_input_dim, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", ConformerBlock(cfg))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """Stacked fbank features (B, T, 160) -> hidden states (B, T, hidden) f32."""
        x = self.fp_projection(self.fp_layer_norm(features))
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x


# -- HF checkpoint import (Wav2Vec2BertModel) ------------------------------------

def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)


def _dense(state: Dict, name: str) -> Dict:
    p = {"kernel": _np(state[f"{name}.weight"]).T}
    if f"{name}.bias" in state:
        p["bias"] = _np(state[f"{name}.bias"])
    return p


def _ln(state: Dict, name: str) -> Dict:
    return {"scale": _np(state[f"{name}.weight"]), "bias": _np(state[f"{name}.bias"])}


def _ffn(state: Dict, name: str) -> Dict:
    return {"intermediate_dense": _dense(state, f"{name}.intermediate_dense"),
            "output_dense": _dense(state, f"{name}.output_dense")}


def w2vbert_params_from_torch(state: Dict, cfg: W2vBertConfig) -> Dict:
    """An HF `Wav2Vec2BertModel` state dict -> the flax `W2vBertModel` tree
    (numpy): the k = 1 pointwise convolutions as Dense kernels, the
    depthwise (h, 1, k) weight in flax's (k, 1, h) layout."""
    params: Dict = {
        "fp_layer_norm": _ln(state, "feature_projection.layer_norm"),
        "fp_projection": _dense(state, "feature_projection.projection"),
    }
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        cm = f"{b}.conv_module"
        params[f"layer_{i}"] = {
            "ffn1_layer_norm": _ln(state, f"{b}.ffn1_layer_norm"),
            "ffn1": _ffn(state, f"{b}.ffn1"),
            "self_attn_layer_norm": _ln(state, f"{b}.self_attn_layer_norm"),
            "self_attn": {
                "linear_q": _dense(state, f"{b}.self_attn.linear_q"),
                "linear_k": _dense(state, f"{b}.self_attn.linear_k"),
                "linear_v": _dense(state, f"{b}.self_attn.linear_v"),
                "linear_out": _dense(state, f"{b}.self_attn.linear_out"),
                "distance_embedding": _np(state[f"{b}.self_attn.distance_embedding.weight"]),
            },
            "conv_module": {
                "layer_norm": _ln(state, f"{cm}.layer_norm"),
                "pointwise_conv1": {"kernel": _np(state[f"{cm}.pointwise_conv1.weight"])[:, :, 0].T},
                "depthwise_conv": {"kernel": np.transpose(_np(state[f"{cm}.depthwise_conv.weight"]), (2, 1, 0))},
                "depthwise_layer_norm": _ln(state, f"{cm}.depthwise_layer_norm"),
                "pointwise_conv2": {"kernel": _np(state[f"{cm}.pointwise_conv2.weight"])[:, :, 0].T},
            },
            "ffn2_layer_norm": _ln(state, f"{b}.ffn2_layer_norm"),
            "ffn2": _ffn(state, f"{b}.ffn2"),
            "final_layer_norm": _ln(state, f"{b}.final_layer_norm"),
        }
    return params


def w2vbert_state_from_torch(state: Dict, cfg: W2vBertConfig) -> dict:
    """An HF `Wav2Vec2BertModel` state dict -> state dict of the port's `W2vBertModel`."""
    from latent_diffusion_speech_tpu_torch.convert import w2vbert_from_jax

    return w2vbert_from_jax(w2vbert_params_from_torch(state, cfg))
