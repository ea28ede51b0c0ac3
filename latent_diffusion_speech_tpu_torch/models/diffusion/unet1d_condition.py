"""General conditional UNet-1D (the reference's `UNet1DConditionModel` layout)
in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unet1d_condition.py`:
every block type of the factories (`blocks.py`), the three mid blocks (or
none), and every conditioning input the JAX model takes: the positional or
Fourier time embedding (`time_proj`), `timestep_cond` through
`time_embedding.cond_proj`, the class embeddings (the `num_class_embeds`
label table, 'timestep', 'identity', 'projection', 'simple_projection',
summed or concatenated), the SDXL `addition_embed_type="text_time"`
(`add_embedding`), `time_embedding_act_fn`, `encoder_hid_proj` and the
encoder states through every cross-attention block, 0/1 attention masks
turned into -10000 biases, the score-SDE skip pyramid of the Skip blocks,
and the ControlNet and T2I-adapter residual hooks.  The Kandinsky surfaces
raise `NotImplementedError` in the config, as in the JAX package.

Where flax infers a width at the call, the torch module fixes it when it
is built: `context_dim` is the width of the `encoder_hidden_states` the
model will be called with (None: called without them, so every attention's
k/v read its block's hidden states, as in Unit2Mel); 'projection' and
'simple_projection' class embeddings and the text_time embedding read
`projection_class_embeddings_input_dim` features, `cond_proj`
`time_cond_proj_dim`.  The up blocks' input widths follow the skips the
down path leaves (each down block's `skip_widths`); a config whose up blocks
want skips the down path does not leave (mixing the encoder/decoder blocks,
which pass none, with blocks that take them, ROADMAP R14) raises
ValueError, where the JAX package fails in the up loop.

Inputs are (B, T, in_channels) with T divisible by 2**num_upsamplers
(GaussianDiffusion pads to that grid).  Submodules are named after the
flax tree (`time_embedding.linear_1`, `class_embedding`, `down_blocks_0`,
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
from latent_diffusion_speech_tpu_torch.utils import profiler

__all__ = ["UNet1DConditionConfig", "UNet1DCondition", "TimestepEmbedding1D", "GaussianFourierProjection1D",
           "timesteps_embedding"]

_SKIP_TYPES = {"SkipDownBlock2D", "AttnSkipDownBlock2D", "SkipUpBlock2D", "AttnSkipUpBlock2D"}
_K_TYPES = {"KDownBlock2D", "KCrossAttnDownBlock2D", "KUpBlock2D", "KCrossAttnUpBlock2D"}
_NO_SKIP_UP = {"UpDecoderBlock2D", "AttnUpDecoderBlock2D"}


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
    encoder_hid_dim_type: Optional[str] = None  # 'text_proj' only (the Kandinsky ones raise)
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    dual_cross_attention: bool = False
    class_embed_type: Optional[str] = None
    addition_embed_type: Optional[str] = None  # 'text_time' only (the Kandinsky ones raise)
    addition_time_embed_dim: Optional[int] = None
    num_class_embeds: Optional[int] = None
    resnet_time_scale_shift: str = "default"
    resnet_skip_time_act: bool = False
    resnet_out_scale_factor: float = 1.0
    time_embedding_type: str = "positional"  # 'positional' | 'fourier'
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
    skip_channels: Optional[int] = None  # Skip blocks' pyramid width (default: in_channels)

    def __post_init__(self):
        if self.encoder_hid_dim_type not in (None, "text_proj"):
            raise NotImplementedError(
                f"encoder_hid_dim_type={self.encoder_hid_dim_type!r} needs a CLIP-style "
                "image encoder (Kandinsky surface) — out of scope for the TTS stack"
            )
        if self.addition_embed_type not in (None, "text_time"):
            raise NotImplementedError(
                f"addition_embed_type={self.addition_embed_type!r} targets image-conditioned "
                "T2I models — only the SDXL 'text_time' form is built here"
            )
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


class GaussianFourierProjection1D(nn.Module):
    """GaussianFourierProjection: fixed random frequencies `weight`
    (N(0, scale^2), frozen), (B,) -> (B, 2 * embedding_size) f32."""

    def __init__(self, embedding_size: int, scale: float = 16.0, flip_sin_to_cos: bool = False):
        super().__init__()
        self.scale, self.flip_sin_to_cos = scale, flip_sin_to_cos
        self.weight = nn.Parameter(torch.empty(embedding_size), requires_grad=False)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.weight.copy_(self.scale * torch.randn(self.weight.shape, generator=generator))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.float()[:, None] * self.weight.float()[None, :] * 2 * math.pi
        sin, cos = torch.sin(args), torch.cos(args)
        return torch.cat([cos, sin], -1) if self.flip_sin_to_cos else torch.cat([sin, cos], -1)


class TimestepEmbedding1D(nn.Module):
    """TimestepEmbedding MLP: linear_1 -> act -> linear_2 (-> post act), the
    `cond_proj` of a `condition` (`cond_proj_dim` wide) added to the input
    first."""

    def __init__(self, in_channels: int, time_embed_dim: int, act_fn: str = "silu",
                 post_act_fn: Optional[str] = None, cond_proj_dim: Optional[int] = None):
        super().__init__()
        self.act = bl.get_activation(act_fn)
        self.post_act = bl.get_activation(post_act_fn) if post_act_fn is not None else None
        if cond_proj_dim is not None:
            self.cond_proj = Dense(cond_proj_dim, in_channels, bias=False)
        self.linear_1 = Dense(in_channels, time_embed_dim)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        if condition is not None:
            if not hasattr(self, "cond_proj"):
                raise ValueError("a timestep condition needs time_cond_proj_dim in the config")
            sample = sample + self.cond_proj(condition)
        h = self.linear_2(self.act(self.linear_1(sample)))
        return self.post_act(h) if self.post_act is not None else h


def _mask_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 0/1 (B, S) mask -> an additive (B, 1, 1, S) bias of 0 / -10000."""
    return None if mask is None else ((1 - mask.float()) * -10000.0)[:, None, None, :]


def _norm(t: str) -> str:
    if t.startswith("UNetRes"):
        t = t[7:]
    return t.replace("1D", "2D")


class UNet1DCondition(nn.Module):
    def __init__(self, cfg: UNet1DConditionConfig, attn_impl: str = "xla", context_dim: Optional[int] = None):
        super().__init__()
        self.cfg, self.context_dim = cfg, context_dim
        n = len(cfg.down_block_types)
        boc = cfg.block_out_channels
        heads = _tup(cfg.attention_head_dim, n)  # diffusers' historical naming: these ARE the head counts
        cross = _tup(cfg.cross_attention_dim, n)
        layers = _tup(cfg.layers_per_block, n)
        tf_layers = _tup(cfg.transformer_layers_per_block, n)
        only_cross = _tup(cfg.only_cross_attention, n)
        mid_only_cross = (
            cfg.mid_block_only_cross_attention
            if cfg.mid_block_only_cross_attention is not None
            else (cfg.only_cross_attention if isinstance(cfg.only_cross_attention, bool) else False)
        )
        self._down = [_norm(t) for t in cfg.down_block_types]
        self._up = [_norm(t) for t in cfg.up_block_types]
        self._mid = None if cfg.mid_block_type is None else _norm(cfg.mid_block_type)
        self.has_skip_pyramid = any(t in _SKIP_TYPES for t in self._down + self._up)

        # time, class and addition embeddings
        if cfg.time_embedding_type == "fourier":
            time_embed_dim = cfg.time_embedding_dim or boc[0] * 2
            self.time_proj = GaussianFourierProjection1D(time_embed_dim // 2, flip_sin_to_cos=cfg.flip_sin_to_cos)
            t_in = 2 * (time_embed_dim // 2)
        else:
            time_embed_dim = cfg.time_embedding_dim or boc[0] * 4
            t_in = boc[0]
        self.time_embedding = TimestepEmbedding1D(t_in, time_embed_dim, act_fn=cfg.act_fn,
                                                  post_act_fn=cfg.timestep_post_act,
                                                  cond_proj_dim=cfg.time_cond_proj_dim)
        proj_in = cfg.projection_class_embeddings_input_dim
        if cfg.class_embed_type in ("projection", "simple_projection") or cfg.addition_embed_type == "text_time":
            if proj_in is None:
                raise ValueError(f"class_embed_type={cfg.class_embed_type!r} / addition_embed_type="
                                 f"{cfg.addition_embed_type!r} need projection_class_embeddings_input_dim")
        if cfg.class_embed_type is None and cfg.num_class_embeds is not None:
            self.class_embedding = nn.Embedding(cfg.num_class_embeds, time_embed_dim)
        elif cfg.class_embed_type == "timestep":
            self.class_embedding = TimestepEmbedding1D(boc[0], time_embed_dim, act_fn=cfg.act_fn)
        elif cfg.class_embed_type == "projection":
            self.class_embedding = TimestepEmbedding1D(proj_in, time_embed_dim, act_fn=cfg.act_fn)
        elif cfg.class_embed_type == "simple_projection":
            self.class_embedding = Dense(proj_in, time_embed_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding1D(proj_in, time_embed_dim, act_fn=cfg.act_fn)
        temb = time_embed_dim * (2 if cfg.class_embeddings_concat else 1)

        if cfg.encoder_hid_dim_type == "text_proj":
            if context_dim is None:
                raise ValueError("encoder_hid_dim_type='text_proj' projects encoder states: give context_dim")
            self.encoder_hid_proj = Dense(context_dim, cross[0])
        block_ctx = cross[0] if hasattr(self, "encoder_hid_proj") else context_dim
        if cfg.dual_cross_attention and block_ctx is None:
            raise ValueError("dual_cross_attention slices the encoder states: give context_dim")
        block_kw = dict(temb_channels=temb, resnet_eps=cfg.norm_eps, resnet_act_fn=cfg.act_fn,
                        resnet_groups=cfg.norm_num_groups, dual_cross_attention=cfg.dual_cross_attention,
                        resnet_time_scale_shift=cfg.resnet_time_scale_shift,
                        resnet_skip_time_act=cfg.resnet_skip_time_act, cross_attention_norm=cfg.cross_attention_norm,
                        attn_impl=attn_impl, context_dim=block_ctx)
        skip_ch = cfg.skip_channels or cfg.in_channels
        self.conv_in = Conv1dSame(cfg.in_channels, boc[0], cfg.conv_in_kernel)

        # down: the width of every skip the path leaves
        res = [boc[0]]
        out_ch = boc[0]
        for i, bt in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, boc[i]
            block = bl.get_down_block(
                bt, num_layers=layers[i], in_channels=in_ch, out_channels=out_ch, add_downsample=i < n - 1,
                transformer_layers_per_block=tf_layers[i], num_attention_heads=heads[i],
                cross_attention_dim=cross[i], downsample_padding=cfg.downsample_padding,
                only_cross_attention=only_cross[i], resnet_out_scale_factor=cfg.resnet_out_scale_factor,
                attention_head_dim=heads[i] if heads[i] is not None else out_ch, skip_channels=skip_ch, **block_kw)
            self.add_module(f"down_blocks_{i}", block)
            res += block.skip_widths
        mid = bl.get_mid_block(
            cfg.mid_block_type, in_channels=boc[-1], num_attention_heads=heads[-1], attention_head_dim=heads[-1],
            cross_attention_dim=cross[-1], transformer_layers_per_block=tf_layers[-1],
            only_cross_attention=mid_only_cross, mid_block_scale_factor=cfg.mid_block_scale_factor, **block_kw)
        if mid is not None:
            self.mid_block = mid

        # up: each block pops its skips (their widths set its resnets'); the
        # K blocks concatenate the last one up front and end at in_channels
        rev_boc = list(reversed(boc))
        width, self._n_skips = boc[-1], []
        for i, bt in enumerate(cfg.up_block_types):
            j = n - 1 - i  # the down level this up block mirrors
            out_ch, in_ch = rev_boc[i], rev_boc[min(i + 1, n - 1)]
            base, num_layers = self._up[i], layers[j] + 1
            n_skips = 0 if base in _NO_SKIP_UP else num_layers - 1 if base in _K_TYPES else num_layers
            skips = res[len(res) - n_skips:] if n_skips else []
            del res[len(res) - len(skips):]
            if base not in _K_TYPES and (len(skips) < n_skips or None in skips):
                raise ValueError(
                    f"up block {i} ({bt}) concatenates {n_skips} skips, but the down path leaves {skips} for it: "
                    "blocks that pass no skips (the encoder/decoder blocks) do not mix with blocks that take them, "
                    "as in the JAX package (ROADMAP R14)")
            self.add_module(f"up_blocks_{i}", bl.get_up_block(
                bt, num_layers=num_layers, in_channels=in_ch, out_channels=out_ch, prev_output_channel=width,
                add_upsample=i < n - 1, transformer_layers_per_block=tf_layers[j], num_attention_heads=heads[j],
                cross_attention_dim=cross[j], only_cross_attention=only_cross[j],
                resnet_out_scale_factor=cfg.resnet_out_scale_factor,
                attention_head_dim=heads[j] if heads[j] is not None else out_ch, skip_channels=skip_ch,
                res_skip_channels=skips[::-1] if n_skips else None, **block_kw))
            self._n_skips.append(n_skips)
            width = in_ch if base in _K_TYPES else out_ch
        if cfg.norm_num_groups is not None:
            self.conv_norm_out = GroupNorm(cfg.norm_num_groups, width, eps=cfg.norm_eps)
        self.conv_out = Conv1dSame(width, cfg.out_channels, cfg.conv_out_kernel)

    def _embedding(self, sample, timestep, class_labels, timestep_cond, added_cond_kwargs) -> torch.Tensor:
        cfg = self.cfg
        boc = cfg.block_out_channels
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(sample.shape[0])
        if hasattr(self, "time_proj"):
            t_emb = self.time_proj(t)
        else:
            t_emb = timesteps_embedding(t, boc[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(t_emb, timestep_cond)

        kind = cfg.class_embed_type
        if hasattr(self, "class_embedding") or kind == "identity":
            if class_labels is None:
                raise ValueError("class_labels should be provided when class embeddings are configured")
            if kind == "timestep":
                class_emb = self.class_embedding(
                    timesteps_embedding(class_labels, boc[0], cfg.flip_sin_to_cos, cfg.freq_shift))
            elif kind == "identity":
                class_emb = class_labels.to(emb.dtype)
            else:
                class_emb = self.class_embedding(class_labels)
            emb = torch.cat([emb, class_emb], -1) if cfg.class_embeddings_concat else emb + class_emb

        if hasattr(self, "add_embedding"):
            text_embeds, time_ids = added_cond_kwargs["text_embeds"], added_cond_kwargs["time_ids"]
            time_embeds = timesteps_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                              cfg.flip_sin_to_cos, cfg.freq_shift).reshape(text_embeds.shape[0], -1)
            emb = emb + self.add_embedding(torch.cat([text_embeds.to(time_embeds.dtype), time_embeds], -1))
        if cfg.time_embedding_act_fn is not None:
            emb = bl.get_activation(cfg.time_embedding_act_fn)(emb)
        return emb

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
        cfg = self.cfg
        if sample.shape[1] % (2 ** cfg.num_upsamplers) != 0:
            raise ValueError(
                f"T={sample.shape[1]} must be divisible by 2**{cfg.num_upsamplers} "
                "(pad upstream, as GaussianDiffusion does)"
            )
        given = None if encoder_hidden_states is None else encoder_hidden_states.shape[-1]
        if given != self.context_dim:
            raise ValueError(f"this model was built for encoder states of width {self.context_dim} "
                             f"(context_dim), called with {given}")
        bias_add, ctx_bias = _mask_bias(attention_mask), _mask_bias(encoder_attention_mask)
        if cfg.center_input_sample:
            sample = 2 * sample - 1.0
        emb = self._embedding(sample, timestep, class_labels, timestep_cond, added_cond_kwargs)
        ehs = encoder_hidden_states
        if hasattr(self, "encoder_hid_proj"):
            ehs = self.encoder_hid_proj(ehs)

        # the score-SDE skip pyramid rides the raw input down
        sample = sample.to(self.conv_in.compute_dtype)
        skip_sample = sample if self.has_skip_pyramid else None
        sample = self.conv_in(sample)
        is_controlnet = mid_block_additional_residual is not None and down_block_additional_residuals is not None
        is_adapter = mid_block_additional_residual is None and down_block_additional_residuals is not None
        adapter = list(down_block_additional_residuals or ())

        res_samples = [sample]
        for i, base in enumerate(self._down):
            with profiler.span(f"unet.down.{i}"):
                block = getattr(self, f"down_blocks_{i}")
                if base in _SKIP_TYPES:
                    sample, skips, skip_sample = block(sample, emb, skip_sample=skip_sample)
                elif base == "CrossAttnDownBlock2D":
                    extra = adapter.pop(0) if (is_adapter and adapter) else None
                    sample, skips = block(sample, emb, ehs, bias_add, ctx_bias, additional_residuals=extra)
                elif base == "KCrossAttnDownBlock2D":
                    sample, skips = block(sample, emb, ehs, bias_add, ctx_bias)
                elif base == "SimpleCrossAttnDownBlock2D":
                    sample, skips = block(sample, emb, ehs, bias_add=ctx_bias if ehs is not None else bias_add)
                else:
                    sample, skips = block(sample, emb)
                    if is_adapter and adapter:
                        sample = sample + adapter.pop(0)
                res_samples.extend(skips)
        if is_controlnet:
            res_samples = [r + c for r, c in zip(res_samples, down_block_additional_residuals)]

        with profiler.span("unet.mid"):
            if self._mid == "UNetMidBlock2DCrossAttn":
                sample = self.mid_block(sample, emb, ehs, bias_add, ctx_bias)
            elif self._mid == "UNetMidBlock2DSimpleCrossAttn":
                sample = self.mid_block(sample, emb, ehs, bias_add=ctx_bias if ehs is not None else bias_add)
            elif self._mid is not None:
                sample = self.mid_block(sample, emb)
        if is_controlnet:
            sample = sample + mid_block_additional_residual

        # the up path's skip pyramid starts afresh: each Skip up block adds
        # its level's contribution, FIR-upsampled level to level
        skip_sample = None
        for i, base in enumerate(self._up):
            with profiler.span(f"unet.up.{i}"):
                block = getattr(self, f"up_blocks_{i}")
                n_skips = self._n_skips[i]
                skips = tuple(res_samples[len(res_samples) - n_skips:]) if n_skips else ()
                del res_samples[len(res_samples) - len(skips):]
                if base in _SKIP_TYPES:
                    sample, skip_sample = block(sample, skips, emb, skip_sample=skip_sample)
                elif base in ("CrossAttnUpBlock2D", "KCrossAttnUpBlock2D"):
                    sample = block(sample, skips, emb, ehs, bias_add, ctx_bias)
                elif base == "SimpleCrossAttnUpBlock2D":
                    sample = block(sample, skips, emb, ehs, bias_add=ctx_bias if ehs is not None else bias_add)
                elif base in _NO_SKIP_UP:
                    sample = block(sample, emb)
                else:
                    sample = block(sample, skips, emb)

        if hasattr(self, "conv_norm_out"):
            sample = bl.get_activation(cfg.act_fn)(self.conv_norm_out(sample).to(self.conv_out.compute_dtype))
        sample = self.conv_out(sample)
        if isinstance(skip_sample, torch.Tensor) and skip_sample.shape == sample.shape:
            sample = sample + skip_sample  # the pyramid ends on the output (UNet2DModel wiring)
        return sample

