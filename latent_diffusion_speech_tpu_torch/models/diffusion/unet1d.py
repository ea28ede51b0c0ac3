"""Conditional UNet-1D denoiser in PyTorch (channels-last at the interface).

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unet1d.py`:
conv_in k3 -> down blocks ([ResBlock + TransformerBlock] x layers, strided
conv downsample between) -> mid (ResBlock + Transformer + ResBlock) -> up
blocks (concat skip + ResBlock (+ Transformer), nearest x2 upsample + conv
between) -> GroupNorm -> SiLU -> conv_out k3.  Public functions take and
return (B, T, C); convolutions run channels-first inside `Conv1dSame`.

`attn_impl` picks the self-attention of every transformer block, as in the
JAX package: 'pallas' sends it through `dot_product_attention(impl=
"pallas")`, the K5 wrapper (`ops/kernels/flash_attention.py`: f32
probabilities, no backward); 'xla' and 'fused' through the K4 wrapper
(`ops/kernels/fused_attention.py`): the CUDA kernels on the card, their
plain versions on the CPU; when a gradient is needed it runs K4's forward
and backward through `FusedAttention`, under `torch.no_grad()` the forward
alone.  K4 rounds the probabilities to the input dtype, as the JAX 'xla'
and 'fused' paths do, so in f32 all three agree and in bf16 'pallas'
differs from the other two as it does in the JAX package.  The lowering
knobs `conv_impl` and `qkv` are kept for field parity with the JAX config
and do not change the numbers; `gelu='auto'` (tanh GELU iff B >= 128) does,
and is kept exactly.  `remat=True` wraps every `ResBlock1D` and
`TransformerBlock1D` in `torch.utils.checkpoint` when a gradient is taken,
as the JAX module wraps them in `nn.remat`: their activations are recomputed
in the backward (K4's forward runs again there) instead of kept, and the
gradients do not change.  Every product computes in its layer's
`compute_dtype` (`ops/layers.py`), so `set_compute_dtype` trains the f32
weights in bf16.
Submodule names follow the flax tree (`down_0_res_0.conv1`, ...), so
`convert.unit2mel_from_jax` maps one onto the other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.kernels.fused_attention import fused_attention
from latent_diffusion_speech_tpu_torch.ops.layers import (ComputeDtype, Dense, GroupNorm, LayerNorm, dense_product,
                                                          local_heads)

__all__ = ["UNet1DConfig", "UNet1D", "timestep_embedding"]


@dataclass(frozen=True)
class UNet1DConfig:
    in_channels: int = 384           # out_dims + n_hidden
    out_channels: int = 128
    block_out_channels: Tuple[int, ...] = (256, 384, 512, 512)
    layers_per_block: int = 2
    n_heads: int = 8
    norm_num_groups: int = 8
    cross_attn: Tuple[bool, ...] = (True, True, True, False)  # per down block
    dropout: float = 0.0
    remat: bool = False
    conv_impl: str = "xla"
    attn_impl: str = "xla"
    gelu: str = "auto"               # 'auto' (tanh iff B >= 128) | 'exact' | 'tanh'
    qkv: str = "split"

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers convention (flip_sin_to_cos, shift 0)
    -> [cos | sin], f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Conv1dSame(ComputeDtype, nn.Conv1d):
    """'Same'-padded odd-kernel Conv1d over (B, T, C) inputs."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.cast_weights()
        if self.split is not None:
            return self.split.linear(x, weight, bias, self._conv)
        return self._conv(x, weight, bias)

    def _conv(self, x, weight, bias):
        y = F.conv1d(x.to(weight.dtype).transpose(1, 2), weight, bias, self.stride, self.padding)
        return y.transpose(1, 2)


class ResBlock1D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = Conv1dSame(in_ch, out_ch, 3)
        self.time_emb_proj = Dense(temb_ch, 2 * out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = Conv1dSame(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = Conv1dSame(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        """x (B, T, C), temb (B, E): 'scale_shift' time conditioning."""
        dtype = self.conv1.compute_dtype
        h = F.silu(self.norm1(x).to(dtype))
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        h = self.norm2(h).to(dtype)
        h = F.silu(h * (1 + scale) + shift)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class SelfAttention(nn.Module):
    def __init__(self, channels: int, n_heads: int, attn_impl: str = "xla"):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.to_q = Dense(channels, channels, bias=False)
        self.to_k = Dense(channels, channels, bias=False)
        self.to_v = Dense(channels, channels, bias=False)
        self.to_out = Dense(channels, channels)

    def plan_tensor_parallel(self) -> None:
        """Under tensor parallelism, run the rank's heads alone when q, k
        and v are column-parallel, `to_out` row-parallel and the chunks hold
        whole heads; otherwise every rank runs every head."""
        self.heads = local_heads(self.n_heads, (self.to_q, self.to_k, self.to_v), self.to_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        H = getattr(self, "heads", self.n_heads)
        q, k, v = (p(x) for p in (self.to_q, self.to_k, self.to_v))
        shape = (B, T, H, q.shape[-1] // H)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        if self.attn_impl == "pallas":
            out = dot_product_attention(q, k, v, impl="pallas")
        else:
            out = fused_attention(q, k, v)
        return self.to_out(out.reshape(B, T, -1))


class GegluFF(ComputeDtype, nn.Linear):
    """GEGLU feed-forward with the diffusers layout: one (C, 8C) projection,
    value half times GELU (tanh approximation if `approx_gelu`) of the gate
    half."""

    def __init__(self, channels: int):
        super().__init__(channels, 8 * channels)

    def forward(self, x: torch.Tensor, approx_gelu: bool = False) -> torch.Tensor:
        """Under tensor parallelism the projection's output features are
        split in contiguous chunks, so one rank's chunk may be all value and
        another's all gate: they are gathered before the split (the
        column-parallel default)."""
        weight, bias = self.cast_weights()
        if self.split is not None:
            y = self.split.linear(x, weight, bias, dense_product)
        else:
            y = dense_product(x, weight, bias)
        a, g = y.chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh" if approx_gelu else "none")


class TransformerBlock1D(nn.Module):
    """Transformer2DModel(num_layers=1) effective runtime path."""

    def __init__(self, channels: int, n_heads: int, groups: int = 8, gelu: str = "auto",
                 attn_impl: str = "xla"):
        super().__init__()
        self.gelu = gelu
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Dense(channels, channels)
        self.norm1 = LayerNorm(channels)
        self.attn1 = SelfAttention(channels, n_heads, attn_impl)
        self.norm2 = LayerNorm(channels)
        self.attn2 = SelfAttention(channels, n_heads, attn_impl)
        self.norm3 = LayerNorm(channels)
        self.ff_proj = GegluFF(channels)
        self.ff_out = Dense(4 * channels, channels)
        self.proj_out = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.proj_in.compute_dtype
        h = self.proj_in(self.norm(x).to(dtype))
        h = h + self.attn1(self.norm1(h).to(dtype))
        h = h + self.attn2(self.norm2(h).to(dtype))
        approx = self.gelu == "tanh" or (self.gelu == "auto" and x.shape[0] >= 128)
        h = h + self.ff_out(self.ff_proj(self.norm3(h).to(dtype), approx))
        return self.proj_out(h) + x


class Downsample1D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv1dSame(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv1dSame(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.repeat_interleave(x, 2, dim=1))  # nearest x2


class UNet1D(nn.Module):
    def __init__(self, cfg: UNet1DConfig):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        n = len(boc)
        g = cfg.norm_num_groups
        E = 4 * boc[0]
        self.time_mlp1 = Dense(boc[0], E)
        self.time_mlp2 = Dense(E, E)
        self.conv_in = Conv1dSame(cfg.in_channels, boc[0], 3)

        skip_ch = [boc[0]]
        ch = boc[0]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock1D(ch, boc[i], E, g))
                ch = boc[i]
                if cfg.cross_attn[i]:
                    self.add_module(f"down_{i}_attn_{j}", TransformerBlock1D(ch, cfg.n_heads, g, cfg.gelu, cfg.attn_impl))
                skip_ch.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", Downsample1D(ch))
                skip_ch.append(ch)

        self.mid_res_0 = ResBlock1D(ch, boc[-1], E, g)
        self.mid_attn = TransformerBlock1D(boc[-1], cfg.n_heads, g, cfg.gelu, cfg.attn_impl)
        self.mid_res_1 = ResBlock1D(boc[-1], boc[-1], E, g)
        ch = boc[-1]

        rev = list(reversed(boc))
        rev_attn = list(reversed(cfg.cross_attn))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock1D(ch + skip_ch.pop(), rev[i], E, g))
                ch = rev[i]
                if rev_attn[i]:
                    self.add_module(f"up_{i}_attn_{j}", TransformerBlock1D(ch, cfg.n_heads, g, cfg.gelu, cfg.attn_impl))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Upsample1D(ch))

        self.conv_norm_out = GroupNorm(g, ch, eps=1e-5)
        self.conv_out = Conv1dSame(ch, cfg.out_channels, 3)

    def _block(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x (B, T, in_channels) noisy spec ++ condition; t (B,) steps.
        Returns eps (B, T, out_channels). T must divide by
        2**(n_blocks-1); GaussianDiffusion pads to that grid."""
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        dtype = self.conv_in.compute_dtype
        temb = self.time_mlp1(timestep_embedding(t, cfg.block_out_channels[0]))
        temb = self.time_mlp2(F.silu(temb))

        h = self.conv_in(x)
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = self._block(f"down_{i}_res_{j}", h, temb)
                if cfg.cross_attn[i]:
                    h = self._block(f"down_{i}_attn_{j}", h)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self._block("mid_res_0", h, temb)
        h = self._block("mid_attn", h)
        h = self._block("mid_res_1", h, temb)

        rev_attn = list(reversed(cfg.cross_attn))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self._block(f"up_{i}_res_{j}", h, temb)
                if rev_attn[i]:
                    h = self._block(f"up_{i}_attn_{j}", h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        h = F.silu(self.conv_norm_out(h).to(dtype))
        return self.conv_out(h)
