"""The UNet blocks of the reference-layout denoiser, in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/blocks.py`,
limited to the blocks that Unit2Mel's effective general configuration
(`Unit2MelConfig.general_unet_config`) instantiates: the resnet with
'default' or 'scale_shift' time conditioning, the transformer with
bias-free attention and a GEGLU (or GELU) feed-forward, the strided-conv
downsampler and the nearest x2 + conv upsampler, and the five block types
`DownBlock2D`, `CrossAttnDownBlock2D`, `UNetMidBlock2DCrossAttn`,
`UpBlock2D` and `CrossAttnUpBlock2D`.  Every other factory type, and
'ada_group', FIR or up/down resampling inside a resnet, raises
`NotImplementedError` (ROADMAP.md).

Tensors are channels-last (B, T, C) at every interface.  The attention
blocks take no encoder states or masks (`UNet1DCondition` has none to give
them); `CrossAttention1D`, `BasicTransformerBlock1D` and `Transformer1D`
take `context` and the additive biases as the JAX modules do.  Fields keep the
JAX names and defaults; where flax infers an input width at call time, the
torch module takes it at construction (`in_channels`, `prev_output_channel`
and the diffusers rule for skip widths).  Submodules are named after the
flax tree (`resnets_0`, `attentions_0.transformer_blocks_0.attn1.to_q`,
`ff.net_0.proj`, `downsamplers_0.conv`, ...), so `convert.unit2mel_from_jax`
maps one onto the other leaf by leaf.  Mixed precision follows
`ops/layers.py`: norms compute in f32 and the caller casts their output to
the compute dtype of the next matmul or convolution.

Every attention goes through `ops/attention.py::dot_product_attention` with
the block's `attn_impl`: 'pallas' is the K5 kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import Conv1dSame
from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, GroupNorm, LayerNorm

__all__ = [
    "get_activation",
    "get_down_block",
    "get_up_block",
    "get_mid_block",
    "DOWN_BLOCK_TYPES",
    "UP_BLOCK_TYPES",
    "MID_BLOCK_TYPES",
    "ConvDownsample1D",
    "ConvUpsample1D",
    "CrossAttention1D",
    "GEGLU1D",
    "GELUProj1D",
    "FeedForward1D",
    "BasicTransformerBlock1D",
    "Transformer1D",
    "ResnetBlock1DFull",
    "DownBlock1D",
    "CrossAttnDownBlock1D",
    "MidBlock1DCrossAttn",
    "UpBlock1D",
    "CrossAttnUpBlock1D",
]

# the JAX factory's names; the ported ones are dispatched below, the others raise
DOWN_BLOCK_TYPES = (
    "DownBlock2D", "ResnetDownsampleBlock2D", "AttnDownBlock2D",
    "CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "SkipDownBlock2D",
    "AttnSkipDownBlock2D", "DownEncoderBlock2D", "AttnDownEncoderBlock2D",
    "KDownBlock2D", "KCrossAttnDownBlock2D",
)
UP_BLOCK_TYPES = (
    "UpBlock2D", "ResnetUpsampleBlock2D", "CrossAttnUpBlock2D",
    "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "SkipUpBlock2D",
    "AttnSkipUpBlock2D", "UpDecoderBlock2D", "AttnUpDecoderBlock2D",
    "KUpBlock2D", "KCrossAttnUpBlock2D",
)
MID_BLOCK_TYPES = ("UNetMidBlock2D", "UNetMidBlock2DCrossAttn", "UNetMidBlock2DSimpleCrossAttn")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package (ROADMAP.md)")


def get_activation(name: str):
    """The JAX package's activations ('gelu' is flax's tanh approximation)."""
    return {
        "swish": F.silu,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "mish": F.mish,
        "relu": F.relu,
    }[name]


# --------------------------------------------------------------------------
# resamplers
# --------------------------------------------------------------------------


class _StridedConv(nn.Conv1d):
    """k3 stride-2 conv over (B, T, C); `padding` pads both ends of T."""

    def __init__(self, in_channels: int, out_channels: int, padding: int):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(self.weight.dtype).transpose(1, 2), self.weight, self.bias, 2, self.padding)
        return y.transpose(1, 2)


class ConvDownsample1D(nn.Module):
    """Downsample2D(use_conv=True): k3 s2 conv; padding=0 zero-pads (0, 1)
    like the reference."""

    def __init__(self, in_channels: int, out_channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = _StridedConv(in_channels, out_channels, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 0, 0, 1))
        return self.conv(x)


class ConvUpsample1D(nn.Module):
    """Upsample2D(use_conv=True): nearest x2 + k3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1dSame(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.repeat_interleave(x, 2, dim=1))


# --------------------------------------------------------------------------
# attention and transformer
# --------------------------------------------------------------------------


class CrossAttention1D(nn.Module):
    """diffusers `Attention` core on channels-last inputs: q from x, k/v from
    `context` (`cross_attention_dim` features; self-attention on x when
    context is None, then x must have that width).  `bias_add` is an
    additive attention bias; with one, `dot_product_attention` takes its
    plain path whatever `attn_impl`, as in the JAX package."""

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: Optional[int] = None,
        bias: bool = False,
        out_bias: bool = True,
        cross_attention_norm: Optional[str] = None,
        cross_attention_norm_num_groups: int = 32,
        attn_impl: str = "xla",
    ):
        super().__init__()
        if cross_attention_norm is not None:
            raise _not_ported(f"cross_attention_norm={cross_attention_norm!r}")
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        self.to_q = Dense(query_dim, inner, bias=bias)
        self.to_k = Dense(ctx_dim, inner, bias=bias)
        self.to_v = Dense(ctx_dim, inner, bias=bias)
        self.to_out_0 = Dense(inner, query_dim, bias=out_bias)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                bias_add: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, Tq, Tk = x.shape[0], x.shape[1], ctx.shape[1]
        out = dot_product_attention(
            self.to_q(x).reshape(B, Tq, self.heads, self.dim_head),
            self.to_k(ctx).reshape(B, Tk, self.heads, self.dim_head),
            self.to_v(ctx).reshape(B, Tk, self.heads, self.dim_head),
            bias=bias_add,
            impl=self.attn_impl,
        ).reshape(B, Tq, self.heads * self.dim_head)
        return self.to_out_0(out)


class GEGLU1D(nn.Module):
    def __init__(self, dim_in: int, inner_dim: int):
        super().__init__()
        self.proj = Dense(dim_in, 2 * inner_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class GELUProj1D(nn.Module):
    def __init__(self, dim_in: int, inner_dim: int):
        super().__init__()
        self.proj = Dense(dim_in, inner_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x))


class FeedForward1D(nn.Module):
    """diffusers FeedForward: net_0 = GEGLU or GELU projection, net_2 = out."""

    def __init__(self, dim: int, mult: int = 4, activation_fn: str = "geglu"):
        super().__init__()
        inner = dim * mult
        if activation_fn == "geglu":
            self.net_0 = GEGLU1D(dim, inner)
        elif activation_fn == "gelu":
            self.net_0 = GELUProj1D(dim, inner)
        else:
            raise NotImplementedError(activation_fn)
        self.net_2 = Dense(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_2(self.net_0(x))


class BasicTransformerBlock1D(nn.Module):
    """BasicTransformerBlock, layer_norm variant: attn1 is self-attention (or
    cross-attention when only_cross_attention), attn2 cross-attention over
    the encoder states (self-attention when they are None), then the
    feed-forward; each pre-normed, each residual."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: Optional[int] = None,
        only_cross_attention: bool = False,
        double_self_attention: bool = False,
        attention_bias: bool = False,
        activation_fn: str = "geglu",
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.only_cross_attention = only_cross_attention
        self.double_self_attention = double_self_attention
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention1D(
            dim, heads, dim_head,
            cross_attention_dim=cross_attention_dim if only_cross_attention else None,
            bias=attention_bias, attn_impl=attn_impl,
        )
        if cross_attention_dim is not None or double_self_attention:
            self.norm2 = LayerNorm(dim)
            self.attn2 = CrossAttention1D(
                dim, heads, dim_head,
                cross_attention_dim=None if double_self_attention else cross_attention_dim,
                bias=attention_bias, attn_impl=attn_impl,
            )
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward1D(dim, activation_fn=activation_fn)

    def forward(self, x, context=None, bias_add=None, context_bias_add=None) -> torch.Tensor:
        dtype = self.ff.net_2.weight.dtype
        ctx1 = context if self.only_cross_attention else None
        x = x + self.attn1(self.norm1(x).to(dtype), ctx1,
                           bias_add=bias_add if ctx1 is None else context_bias_add)
        if hasattr(self, "attn2"):
            ctx2 = None if self.double_self_attention else context
            x = x + self.attn2(self.norm2(x).to(dtype), ctx2,
                               bias_add=context_bias_add if ctx2 is not None else bias_add)
        return x + self.ff(self.norm3(x).to(dtype))


class Transformer1D(nn.Module):
    """Transformer2DModel, continuous path: GroupNorm -> proj_in -> N blocks
    -> proj_out -> + residual."""

    def __init__(
        self,
        num_attention_heads: int,
        attention_head_dim: int,
        in_channels: int,
        num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
        norm_num_groups: int = 32,
        only_cross_attention: bool = False,
        double_self_attention: bool = False,
        attention_bias: bool = False,
        activation_fn: str = "geglu",
        attn_impl: str = "xla",
    ):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.num_layers = num_layers
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = Dense(in_channels, inner)
        for i in range(num_layers):
            self.add_module(f"transformer_blocks_{i}", BasicTransformerBlock1D(
                inner, num_attention_heads, attention_head_dim,
                cross_attention_dim=cross_attention_dim,
                only_cross_attention=only_cross_attention,
                double_self_attention=double_self_attention,
                attention_bias=attention_bias, activation_fn=activation_fn, attn_impl=attn_impl,
            ))
        self.proj_out = Dense(inner, in_channels)

    def forward(self, x, context=None, bias_add=None, context_bias_add=None) -> torch.Tensor:
        h = self.proj_in(self.norm(x).to(self.proj_in.weight.dtype))
        for i in range(self.num_layers):
            h = getattr(self, f"transformer_blocks_{i}")(h, context, bias_add, context_bias_add)
        return self.proj_out(h) + x


# --------------------------------------------------------------------------
# resnet
# --------------------------------------------------------------------------


class ResnetBlock1DFull(nn.Module):
    """ResnetBlock2D in 1-D with time_embedding_norm 'default' (the time
    projection added after conv1) or 'scale_shift' (h * (1 + scale) + shift
    after norm2), skip_time_act, output_scale_factor, a forced or bias-free
    shortcut and a distinct conv2 width.  'ada_group', and FIR or up/down
    resampling inside the block, raise."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = 512,
        groups: int = 32,
        groups_out: Optional[int] = None,
        eps: float = 1e-6,
        non_linearity: str = "swish",
        skip_time_act: bool = False,
        time_embedding_norm: str = "default",
        kernel: Optional[str] = None,
        output_scale_factor: float = 1.0,
        use_in_shortcut: Optional[bool] = None,
        up: bool = False,
        down: bool = False,
        conv_shortcut_bias: bool = True,
        conv_out_channels: Optional[int] = None,
        conv_impl: str = "xla",
    ):
        super().__init__()
        if time_embedding_norm not in ("default", "scale_shift"):
            raise _not_ported(f"time_embedding_norm={time_embedding_norm!r}")
        if up or down or kernel is not None:
            raise _not_ported("resampling inside a resnet (up/down, FIR kernel)")
        conv_out_ch = conv_out_channels or out_channels
        self.act = get_activation(non_linearity)
        self.skip_time_act = skip_time_act
        self.time_embedding_norm = time_embedding_norm
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv1dSame(in_channels, out_channels, 3)
        if temb_channels is not None:
            width = 2 * out_channels if time_embedding_norm == "scale_shift" else out_channels
            self.time_emb_proj = Dense(temb_channels, width)
        self.norm2 = GroupNorm(groups_out if groups_out is not None else groups, out_channels, eps=eps)
        self.conv2 = Conv1dSame(out_channels, conv_out_ch, 3)
        use_sc = in_channels != conv_out_ch if use_in_shortcut is None else use_in_shortcut
        if use_sc:
            self.conv_shortcut = Conv1dSame(in_channels, conv_out_ch, 1, bias=conv_shortcut_bias)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(self.act(self.norm1(x).to(dtype)))
        emb = None
        if temb is not None and hasattr(self, "time_emb_proj"):
            emb = self.time_emb_proj(temb if self.skip_time_act else self.act(temb))[:, None, :]
        if emb is not None and self.time_embedding_norm == "default":
            h = h + emb
        h = self.norm2(h).to(dtype)
        if emb is not None and self.time_embedding_norm == "scale_shift":
            scale, shift = emb.chunk(2, dim=-1)
            h = h * (1 + scale) + shift
        h = self.conv2(self.act(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return (x + h) / self.output_scale_factor


# --------------------------------------------------------------------------
# down, mid and up blocks
# --------------------------------------------------------------------------


def _resnets(module: nn.Module, in_widths: Sequence[int], out_channels: int, temb_channels, groups, eps,
             act_fn, time_scale_shift, output_scale_factor) -> None:
    for i, width in enumerate(in_widths):
        module.add_module(f"resnets_{i}", ResnetBlock1DFull(
            width, out_channels, temb_channels, groups=groups, eps=eps, non_linearity=act_fn,
            time_embedding_norm=time_scale_shift, output_scale_factor=output_scale_factor,
        ))


def _transformer(out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                 resnet_groups, dual_cross_attention, only_cross_attention, attn_impl) -> Transformer1D:
    if dual_cross_attention:
        raise _not_ported("dual_cross_attention (DualTransformer1D)")
    return Transformer1D(
        num_attention_heads, out_channels // num_attention_heads, out_channels,
        num_layers=transformer_layers_per_block, cross_attention_dim=cross_attention_dim,
        norm_num_groups=resnet_groups, only_cross_attention=only_cross_attention, attn_impl=attn_impl,
    )


class DownBlock1D(nn.Module):
    """DownBlock2D: resnets, each output a skip, then the strided-conv
    downsampler (its output a skip too)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_downsample: bool = True,
        downsample_padding: int = 1,
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, [in_channels] + [out_channels] * (num_layers - 1), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        if add_downsample:
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips += (x,)
        return x, skips


class CrossAttnDownBlock1D(nn.Module):
    """CrossAttnDownBlock2D: (resnet, transformer) pairs, each pair's output
    a skip, then the downsampler."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        transformer_layers_per_block: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        num_attention_heads: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        downsample_padding: int = 1,
        add_downsample: bool = True,
        dual_cross_attention: bool = False,
        only_cross_attention: bool = False,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, [in_channels] + [out_channels] * (num_layers - 1), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                resnet_groups, dual_cross_attention, only_cross_attention, attn_impl))
        if add_downsample:
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"attentions_{i}")(getattr(self, f"resnets_{i}")(x, temb))
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips += (x,)
        return x, skips


class MidBlock1DCrossAttn(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet, then (transformer, resnet) pairs."""

    def __init__(
        self,
        in_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        transformer_layers_per_block: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: Optional[int] = 32,
        num_attention_heads: int = 1,
        output_scale_factor: float = 1.0,
        cross_attention_dim: int = 1280,
        dual_cross_attention: bool = False,
        only_cross_attention: bool = False,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers = num_layers
        groups = resnet_groups if resnet_groups is not None else min(in_channels // 4, 32)
        _resnets(self, [in_channels] * (num_layers + 1), in_channels, temb_channels, groups, resnet_eps,
                 resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                in_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                groups, dual_cross_attention, only_cross_attention, attn_impl))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.resnets_0(x, temb)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i + 1}")(getattr(self, f"attentions_{i}")(x), temb)
        return x


def _up_widths(in_channels: int, prev_output_channel: int, out_channels: int, num_layers: int) -> list:
    """Input width of each resnet of an up block: the running hidden state
    (prev_output_channel, then out_channels) plus the skip it concatenates
    (out_channels, and in_channels for the last), as diffusers builds it."""
    return [(prev_output_channel if i == 0 else out_channels)
            + (in_channels if i == num_layers - 1 else out_channels) for i in range(num_layers)]


class UpBlock1D(nn.Module):
    """UpBlock2D: per layer, concat one popped skip, then a resnet; then the
    nearest x2 + conv upsampler."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, _up_widths(in_channels, prev_output_channel, out_channels, num_layers), out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor)
        if add_upsample:
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(torch.cat([x, skips.pop()], dim=-1), temb)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class CrossAttnUpBlock1D(nn.Module):
    """CrossAttnUpBlock2D: per layer, concat one popped skip, a resnet and a
    transformer; then the upsampler."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        transformer_layers_per_block: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        num_attention_heads: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
        dual_cross_attention: bool = False,
        only_cross_attention: bool = False,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, _up_widths(in_channels, prev_output_channel, out_channels, num_layers), out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                resnet_groups, dual_cross_attention, only_cross_attention, attn_impl))
        if add_upsample:
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(torch.cat([x, skips.pop()], dim=-1), temb)
            x = getattr(self, f"attentions_{i}")(x)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------


def _norm_type(t: str) -> str:
    if t.startswith("UNetRes"):
        t = t[7:]
    return t.replace("1D", "2D")  # accept 1D aliases


def get_down_block(
    down_block_type: str,
    num_layers: int,
    in_channels: int,
    out_channels: int,
    temb_channels: Optional[int],
    add_downsample: bool,
    resnet_eps: float,
    resnet_act_fn: str,
    transformer_layers_per_block: int = 1,
    num_attention_heads: Optional[int] = None,
    resnet_groups: Optional[int] = None,
    cross_attention_dim: Optional[int] = None,
    downsample_padding: Optional[int] = None,
    dual_cross_attention: bool = False,
    use_linear_projection: bool = False,
    only_cross_attention: bool = False,
    upcast_attention: bool = False,
    resnet_time_scale_shift: str = "default",
    resnet_skip_time_act: bool = False,
    resnet_out_scale_factor: float = 1.0,
    cross_attention_norm: Optional[str] = None,
    attention_head_dim: Optional[int] = None,
    downsample_type: Optional[str] = None,
    skip_channels: int = 1,
    attn_impl: str = "xla",
) -> nn.Module:
    """The JAX `get_down_block` for the two ported types; the others raise."""
    t = _norm_type(down_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    pad = downsample_padding if downsample_padding is not None else 1
    common = dict(num_layers=num_layers, resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn,
                  resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
                  add_downsample=add_downsample, downsample_padding=pad)
    if t == "DownBlock2D":
        return DownBlock1D(in_channels, out_channels, temb_channels, **common)
    if t == "CrossAttnDownBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnDownBlock2D")
        return CrossAttnDownBlock1D(
            in_channels, out_channels, temb_channels,
            transformer_layers_per_block=transformer_layers_per_block,
            num_attention_heads=num_attention_heads, cross_attention_dim=cross_attention_dim,
            dual_cross_attention=dual_cross_attention, only_cross_attention=only_cross_attention,
            attn_impl=attn_impl, **common)
    if t in DOWN_BLOCK_TYPES:
        raise _not_ported(f"down block type {down_block_type!r}")
    raise ValueError(f"{down_block_type} does not exist.")


def get_up_block(
    up_block_type: str,
    num_layers: int,
    in_channels: int,
    out_channels: int,
    prev_output_channel: int,
    temb_channels: Optional[int],
    add_upsample: bool,
    resnet_eps: float,
    resnet_act_fn: str,
    transformer_layers_per_block: int = 1,
    num_attention_heads: Optional[int] = None,
    resnet_groups: Optional[int] = None,
    cross_attention_dim: Optional[int] = None,
    dual_cross_attention: bool = False,
    use_linear_projection: bool = False,
    only_cross_attention: bool = False,
    upcast_attention: bool = False,
    resnet_time_scale_shift: str = "default",
    resnet_skip_time_act: bool = False,
    resnet_out_scale_factor: float = 1.0,
    cross_attention_norm: Optional[str] = None,
    attention_head_dim: Optional[int] = None,
    upsample_type: Optional[str] = None,
    skip_channels: int = 1,
    attn_impl: str = "xla",
) -> nn.Module:
    """The JAX `get_up_block` for the two ported types; the others raise."""
    t = _norm_type(up_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    common = dict(num_layers=num_layers, resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn,
                  resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
                  add_upsample=add_upsample)
    if t == "UpBlock2D":
        return UpBlock1D(in_channels, prev_output_channel, out_channels, temb_channels, **common)
    if t == "CrossAttnUpBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnUpBlock2D")
        return CrossAttnUpBlock1D(
            in_channels, prev_output_channel, out_channels, temb_channels,
            transformer_layers_per_block=transformer_layers_per_block,
            num_attention_heads=num_attention_heads, cross_attention_dim=cross_attention_dim,
            dual_cross_attention=dual_cross_attention, only_cross_attention=only_cross_attention,
            attn_impl=attn_impl, **common)
    if t in UP_BLOCK_TYPES:
        raise _not_ported(f"up block type {up_block_type!r}")
    raise ValueError(f"{up_block_type} does not exist.")


def get_mid_block(
    mid_block_type: Optional[str],
    in_channels: int,
    temb_channels: Optional[int],
    resnet_eps: float = 1e-5,
    resnet_act_fn: str = "silu",
    resnet_groups: Optional[int] = 32,
    num_attention_heads: int = 1,
    attention_head_dim: Optional[int] = None,
    cross_attention_dim: Optional[int] = None,
    transformer_layers_per_block: int = 1,
    dual_cross_attention: bool = False,
    only_cross_attention: bool = False,
    resnet_time_scale_shift: str = "default",
    resnet_skip_time_act: bool = False,
    mid_block_scale_factor: float = 1.0,
    cross_attention_norm: Optional[str] = None,
    attn_impl: str = "xla",
) -> Optional[nn.Module]:
    """The JAX `get_mid_block` for `UNetMidBlock2DCrossAttn` (and None); the
    other mid blocks raise."""
    if mid_block_type is None:
        return None
    t = _norm_type(mid_block_type)
    if t == "UNetMidBlock2DCrossAttn":
        return MidBlock1DCrossAttn(
            in_channels, temb_channels, resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn,
            resnet_groups=resnet_groups, resnet_time_scale_shift=resnet_time_scale_shift,
            transformer_layers_per_block=transformer_layers_per_block,
            num_attention_heads=num_attention_heads, cross_attention_dim=cross_attention_dim,
            dual_cross_attention=dual_cross_attention, only_cross_attention=only_cross_attention,
            output_scale_factor=mid_block_scale_factor, attn_impl=attn_impl)
    if t in MID_BLOCK_TYPES:
        raise _not_ported(f"mid block type {mid_block_type!r}")
    raise ValueError(f"unknown mid_block_type : {mid_block_type}")
