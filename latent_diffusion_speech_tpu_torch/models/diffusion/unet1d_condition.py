"""General conditional UNet-1D (the reference's `UNet1DConditionModel` layout)
in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unet1d_condition.py`,
for what Unit2Mel's general denoiser (`Unit2MelConfig(denoiser="general")`)
runs: the positional time embedding, conv_in, the down blocks, the mid block,
the up blocks with their skip concatenations, GroupNorm + activation and
conv_out, with the block types `DownBlock2D`, `CrossAttnDownBlock2D`,
`UNetMidBlock2DCrossAttn`, `UpBlock2D` and `CrossAttnUpBlock2D`
(`blocks.py`).  Without encoder states every attention of those blocks is a
bias-free self-attention over the block's hidden states, so with
`attn_impl="pallas"` each is one K5 launch on the card (32 a forward at the
flagship widths).

`UNet1DConditionConfig` has every field and default of the JAX config.  Not
ported, and raising `NotImplementedError` when set (ROADMAP.md): class and
addition embeddings, `encoder_hid_dim_type`, Fourier time, `time_cond_proj_dim`,
the other block types (so the skip pyramids), and at `forward` the encoder
states, attention masks, ControlNet / adapter residuals and the other
conditioning inputs.  Inputs are (B, T, in_channels) with T divisible by
2**num_upsamplers (GaussianDiffusion pads to that grid).  Submodules are
named after the flax tree (`time_embedding.linear_1`, `down_blocks_0`,
`mid_block`, `up_blocks_3`, `conv_norm_out`, ...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import nn

from latent_diffusion_speech_tpu_torch.models.diffusion import blocks as bl
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import Conv1dSame
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, GroupNorm

__all__ = ["UNet1DConditionConfig", "UNet1DCondition", "TimestepEmbedding1D", "timesteps_embedding"]


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


@dataclass(frozen=True)
class UNet1DConditionConfig:
    in_channels: int = 4
    out_channels: int = 4
    center_input_sample: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    only_cross_attention: Union[bool, Tuple[bool, ...]] = False
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: Union[int, Tuple[int, ...]] = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    act_fn: str = "silu"
    norm_num_groups: Optional[int] = 32
    norm_eps: float = 1e-5
    cross_attention_dim: Union[int, Tuple[int, ...]] = 1280
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    encoder_hid_dim: Optional[int] = None
    encoder_hid_dim_type: Optional[str] = None
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    dual_cross_attention: bool = False
    class_embed_type: Optional[str] = None
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    num_class_embeds: Optional[int] = None
    resnet_time_scale_shift: str = "default"
    resnet_skip_time_act: bool = False
    resnet_out_scale_factor: float = 1.0
    time_embedding_type: str = "positional"  # 'positional' ('fourier' is not ported)
    time_embedding_dim: Optional[int] = None
    time_embedding_act_fn: Optional[str] = None
    timestep_post_act: Optional[str] = None
    time_cond_proj_dim: Optional[int] = None
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    projection_class_embeddings_input_dim: Optional[int] = None
    class_embeddings_concat: bool = False
    mid_block_only_cross_attention: Optional[bool] = None
    cross_attention_norm: Optional[str] = None
    skip_channels: Optional[int] = None

    def __post_init__(self):
        if len(self.down_block_types) != len(self.up_block_types):
            raise ValueError("down_block_types and up_block_types must have equal length")
        if len(self.block_out_channels) != len(self.down_block_types):
            raise ValueError("block_out_channels must match down_block_types")

    @property
    def num_upsamplers(self) -> int:
        return len(self.up_block_types) - 1


def timesteps_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, freq_shift: float,
                        max_period: float = 10000.0) -> torch.Tensor:
    """diffusers `get_timestep_embedding`: (B,) -> (B, dim) f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin], -1) if flip_sin_to_cos else torch.cat([sin, cos], -1)
    if dim % 2 == 1:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


class TimestepEmbedding1D(nn.Module):
    """TimestepEmbedding MLP: linear_1 -> act -> linear_2 (-> post act).
    The `cond_proj` input (`timestep_cond`) is not ported."""

    def __init__(self, in_channels: int, time_embed_dim: int, act_fn: str = "silu",
                 post_act_fn: Optional[str] = None, cond_proj_dim: Optional[int] = None):
        super().__init__()
        if cond_proj_dim is not None:
            raise bl._not_ported("time_cond_proj_dim (timestep_cond)")
        self.act = bl.get_activation(act_fn)
        self.post_act = bl.get_activation(post_act_fn) if post_act_fn is not None else None
        self.linear_1 = Dense(in_channels, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        h = self.linear_2(self.act(self.linear_1(sample)))
        return self.post_act(h) if self.post_act is not None else h


class UNet1DCondition(nn.Module):
    def __init__(self, cfg: UNet1DConditionConfig, attn_impl: str = "xla"):
        super().__init__()
        for name in ("class_embed_type", "num_class_embeds", "addition_embed_type", "encoder_hid_dim_type"):
            if getattr(cfg, name) is not None:
                raise bl._not_ported(f"{name}={getattr(cfg, name)!r}")
        if cfg.time_embedding_type != "positional":
            raise bl._not_ported(f"time_embedding_type={cfg.time_embedding_type!r}")
        self.cfg = cfg
        n = len(cfg.down_block_types)
        boc = cfg.block_out_channels
        heads = _tup(cfg.attention_head_dim, n)  # diffusers' naming: these are the head counts
        cross = _tup(cfg.cross_attention_dim, n)
        layers = _tup(cfg.layers_per_block, n)
        tf_layers = _tup(cfg.transformer_layers_per_block, n)
        only_cross = _tup(cfg.only_cross_attention, n)
        mid_only_cross = (
            cfg.mid_block_only_cross_attention
            if cfg.mid_block_only_cross_attention is not None
            else (cfg.only_cross_attention if isinstance(cfg.only_cross_attention, bool) else False)
        )
        # no encoder states: k/v read the block's own hidden states, so their
        # input width is the block's (flax infers it the same way)
        kv_dim = [None if c is None else w for c, w in zip(cross, boc)]
        time_embed_dim = cfg.time_embedding_dim or boc[0] * 4
        block_kw = dict(temb_channels=time_embed_dim, resnet_eps=cfg.norm_eps, resnet_act_fn=cfg.act_fn,
                        resnet_groups=cfg.norm_num_groups, dual_cross_attention=cfg.dual_cross_attention,
                        resnet_time_scale_shift=cfg.resnet_time_scale_shift,
                        resnet_skip_time_act=cfg.resnet_skip_time_act, cross_attention_norm=cfg.cross_attention_norm,
                        attn_impl=attn_impl)

        self.time_embedding = TimestepEmbedding1D(
            boc[0], time_embed_dim, act_fn=cfg.act_fn, post_act_fn=cfg.timestep_post_act,
            cond_proj_dim=cfg.time_cond_proj_dim,
        )
        self.conv_in = Conv1dSame(cfg.in_channels, boc[0], cfg.conv_in_kernel)

        out_ch = boc[0]
        for i, bt in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, boc[i]
            self.add_module(f"down_blocks_{i}", bl.get_down_block(
                bt, num_layers=layers[i], in_channels=in_ch, out_channels=out_ch,
                add_downsample=i < n - 1, transformer_layers_per_block=tf_layers[i],
                num_attention_heads=heads[i], cross_attention_dim=kv_dim[i],
                downsample_padding=cfg.downsample_padding, only_cross_attention=only_cross[i],
                resnet_out_scale_factor=cfg.resnet_out_scale_factor, attention_head_dim=heads[i],
                **block_kw,
            ))
        mid = bl.get_mid_block(
            cfg.mid_block_type, in_channels=boc[-1], num_attention_heads=heads[-1],
            attention_head_dim=heads[-1], cross_attention_dim=kv_dim[-1],
            transformer_layers_per_block=tf_layers[-1], only_cross_attention=mid_only_cross,
            mid_block_scale_factor=cfg.mid_block_scale_factor, **block_kw,
        )
        if mid is not None:
            self.mid_block = mid

        rev_boc = list(reversed(boc))
        out_ch = rev_boc[0]
        for i, bt in enumerate(cfg.up_block_types):
            prev_ch, out_ch = out_ch, rev_boc[i]
            j = n - 1 - i  # the down level this up block mirrors
            self.add_module(f"up_blocks_{i}", bl.get_up_block(
                bt, num_layers=layers[j] + 1, in_channels=rev_boc[min(i + 1, n - 1)], out_channels=out_ch,
                prev_output_channel=prev_ch, add_upsample=i < n - 1,
                transformer_layers_per_block=tf_layers[j], num_attention_heads=heads[j],
                cross_attention_dim=kv_dim[j], only_cross_attention=only_cross[j],
                resnet_out_scale_factor=cfg.resnet_out_scale_factor, attention_head_dim=heads[j],
                **block_kw,
            ))
        if cfg.norm_num_groups is not None:
            self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], eps=cfg.norm_eps)
        self.conv_out = Conv1dSame(boc[0], cfg.out_channels, cfg.conv_out_kernel)

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        class_labels: Optional[torch.Tensor] = None,
        timestep_cond: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        added_cond_kwargs: Optional[dict] = None,
        down_block_additional_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """sample (B, T, in_channels), timestep (B,) or scalar -> (B, T, out_channels)."""
        given = dict(encoder_hidden_states=encoder_hidden_states, class_labels=class_labels,
                     timestep_cond=timestep_cond, attention_mask=attention_mask,
                     encoder_attention_mask=encoder_attention_mask, added_cond_kwargs=added_cond_kwargs,
                     down_block_additional_residuals=down_block_additional_residuals,
                     mid_block_additional_residual=mid_block_additional_residual)
        for name, value in given.items():
            if value is not None:
                raise bl._not_ported(f"UNet1DCondition input {name}")
        cfg = self.cfg
        n = len(cfg.down_block_types)
        if sample.shape[1] % (2 ** cfg.num_upsamplers) != 0:
            raise ValueError(
                f"T={sample.shape[1]} must be divisible by 2**{cfg.num_upsamplers} "
                "(pad upstream, as GaussianDiffusion does)"
            )
        if cfg.center_input_sample:
            sample = 2 * sample - 1.0
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(sample.shape[0])
        emb = self.time_embedding(
            timesteps_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift))
        if cfg.time_embedding_act_fn is not None:
            emb = bl.get_activation(cfg.time_embedding_act_fn)(emb)

        sample = self.conv_in(sample)
        res_samples = [sample]
        for i in range(n):
            sample, skips = getattr(self, f"down_blocks_{i}")(sample, emb)
            res_samples.extend(skips)
        if hasattr(self, "mid_block"):
            sample = self.mid_block(sample, emb)
        for i in range(n):
            block = getattr(self, f"up_blocks_{i}")
            n_skips = block.num_layers
            skips = res_samples[len(res_samples) - n_skips:]
            del res_samples[len(res_samples) - n_skips:]
            sample = block(sample, skips, emb)

        if hasattr(self, "conv_norm_out"):
            sample = bl.get_activation(cfg.act_fn)(self.conv_norm_out(sample).to(self.conv_out.weight.dtype))
        return self.conv_out(sample)
