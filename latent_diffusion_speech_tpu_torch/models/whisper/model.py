"""Whisper audio encoder (the semantic unit extractor's backbone).

Counterpart of `latent_diffusion_speech_tpu/models/whisper/model.py` (the
reference's `encoder/whisper/model.py:42-131`): conv k3 -> GELU -> conv k3
stride 2 -> GELU -> + sinusoidal positions -> N pre-LN residual attention
blocks (a key projection without bias, a 4x exact-GELU MLP) -> final
LayerNorm.  large-v3: 128 mels, 1280 wide, 20 heads, 32 layers; the units
are 1280-d at half the mel frame rate (hop 320 at 16 kHz).

The submodules carry the reference checkpoint's names (`conv1`, `conv2`,
`blocks.{i}.attn_ln`, `blocks.{i}.attn.{query,key,value,out}`,
`blocks.{i}.mlp_ln`, `blocks.{i}.mlp.0`, `blocks.{i}.mlp.2`, `ln_post`),
so its `model_state_dict` loads with `load_state_dict` once the `encoder.`
prefix is stripped.  Mixed precision follows the JAX module: the products
run in the weights' dtype (`cast_compute_dtype`), the LayerNorms in f32
with their output cast back to it, and `ln_post` returns f32 units.
Attention is the plain `dot_product_attention` (`impl="xla"`), as in JAX:
neither package routes Whisper to a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, LayerNorm

__all__ = ["WhisperDims", "sinusoids", "MHA", "ResidualAttentionBlock", "WhisperEncoder", "init_weights"]


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 32

    @classmethod
    def from_checkpoint_dims(cls, dims: dict) -> "WhisperDims":
        return cls(
            n_mels=dims["n_mels"],
            n_audio_ctx=dims["n_audio_ctx"],
            n_audio_state=dims["n_audio_state"],
            n_audio_head=dims["n_audio_head"],
            n_audio_layer=dims["n_audio_layer"],
        )


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0, device=None) -> torch.Tensor:
    """Sinusoidal positions (length, channels) f32 (reference model.py:35-40)."""
    assert channels % 2 == 0
    log_inc = float(np.log(max_timescale) / (channels // 2 - 1))
    inv = torch.exp(-log_inc * torch.arange(channels // 2, device=device))
    scaled = torch.arange(length, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


class MHA(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = Dense(n_state, n_state)
        self.key = Dense(n_state, n_state, bias=False)
        self.value = Dense(n_state, n_state)
        self.out = Dense(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        q, k, v = (p(x).reshape(B, T, self.n_head, C // self.n_head) for p in (self.query, self.key, self.value))
        return self.out(dot_product_attention(q, k, v).reshape(B, T, C))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn_ln = LayerNorm(n_state, eps=1e-5)
        self.attn = MHA(n_state, n_head)
        self.mlp_ln = LayerNorm(n_state, eps=1e-5)
        self.mlp = nn.Sequential(Dense(n_state, 4 * n_state), nn.GELU(), Dense(4 * n_state, n_state))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.attn.query.weight.dtype
        x = x + self.attn(self.attn_ln(x).to(dtype))
        return x + self.mlp(self.mlp_ln(x).to(dtype))


class WhisperEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        n = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, n, 3, padding=1)
        self.conv2 = nn.Conv1d(n, n, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(n, dims.n_audio_head) for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(n, eps=1e-5)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, T) -> units (B, ceil(T / 2), n_state) f32."""
        x = F.gelu(self.conv1(mel.to(self.conv1.weight.dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + sinusoids(x.shape[1], self.dims.n_audio_state, device=x.device).to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The flax initialisers the JAX module is seeded with: products
    LeCun-normal (truncated at two standard deviations), biases 0,
    LayerNorms 1 and 0; drawn on the module's device from `generator`."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # flax's truncated_normal correction
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
