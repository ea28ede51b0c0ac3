"""The UNet block zoo of the reference-layout denoiser, in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/blocks.py`:
every block type its factories reach (`DOWN_BLOCK_TYPES`, `UP_BLOCK_TYPES`,
`MID_BLOCK_TYPES`), the full resnet (time conditioning 'default',
'scale_shift' or 'ada_group', in-block up/down resampling with the nearest,
avg-pool or FIR filters), the attention variants (the transformer with
bias-free attention and a GEGLU or GELU feed-forward, the dual transformer,
the deprecated-style `AttnBlock1D`, the added-K/V attention and the K
attention), and the resamplers as plain tensor ops over T.

Tensors are channels-last (B, T, C) at every interface.  Fields keep the
JAX names and defaults; where flax infers an input width at call time, the
torch module takes it at construction: `in_channels`, `prev_output_channel`
(the width of the running hidden state an up block receives), the
diffusers rule for skip widths, and `context_dim`, the width of the
encoder states a block is called with (None: it is called without them,
so the k/v projections read the block's own hidden states).  The modules
that existed before `context_dim` (`CrossAttention1D`,
`BasicTransformerBlock1D`, `Transformer1D` and the blocks built on them)
take `cross_attention_dim` as the width their k/v read.  A
`cross_attention_norm` applies to encoder states only, so a module has
`norm_cross` only when it is built for them.  Submodules are named after the
flax tree (`resnets_0`, `attentions_0.transformer_blocks_0.attn1.to_q`,
`ff.net_0.proj`, `downsamplers_0.conv`, `attentions_0.add_k_proj`,
`resnet_down`, `skip_conv`, ...), so `convert.unit2mel_from_jax` maps one
onto the other leaf by leaf.  Mixed precision follows `ops/layers.py`:
norms compute in f32 and the caller casts their output to the compute
dtype of the next matmul or convolution.

Every attention goes through `ops/attention.py::dot_product_attention` with
the block's `attn_impl`: 'pallas' is the K5 kernel on the card, 'fused' K4
where eligible.  The attention blocks that take `attention_head_dim` as the
head width (`AttnBlock1D`, `AddedKVAttention1D`, `KAttention1D`) run heads
of dim 8 in Unit2Mel's general config (`n_heads` = 8); the kernels take it.
As in the JAX package, `DualTransformer1D` runs the plain attention.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    "nearest_up2",
    "avg_down2",
    "upfirdn1d",
    "fir_up2",
    "fir_down2",
    "k_down2",
    "k_up2",
    "ConvDownsample1D",
    "ConvUpsample1D",
    "FirDownsample1D",
    "FirUpsample1D",
    "AdaGroupNorm1D",
    "CrossAttention1D",
    "AttnBlock1D",
    "AddedKVAttention1D",
    "GEGLU1D",
    "GELUProj1D",
    "FeedForward1D",
    "BasicTransformerBlock1D",
    "Transformer1D",
    "DualTransformer1D",
    "KAttention1D",
    "ResnetBlock1DFull",
    "DownBlock1D",
    "ResnetDownsampleBlock1D",
    "AttnDownBlock1D",
    "CrossAttnDownBlock1D",
    "SimpleCrossAttnDownBlock1D",
    "SkipDownBlock1D",
    "DownEncoderBlock1D",
    "KDownBlock1D",
    "KCrossAttnDownBlock1D",
    "UpBlock1D",
    "ResnetUpsampleBlock1D",
    "AttnUpBlock1D",
    "CrossAttnUpBlock1D",
    "SimpleCrossAttnUpBlock1D",
    "SkipUpBlock1D",
    "UpDecoderBlock1D",
    "KUpBlock1D",
    "KCrossAttnUpBlock1D",
    "MidBlock1D",
    "MidBlock1DCrossAttn",
    "MidBlock1DSimpleCrossAttn",
]

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
# resamplers: plain tensor ops over the T axis of (B, T, C)
# --------------------------------------------------------------------------


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return torch.repeat_interleave(x, 2, dim=1)


def avg_down2(x: torch.Tensor) -> torch.Tensor:
    """Average pool k2 s2 over T (an odd last frame dropped, as torch's pool)."""
    t = (x.shape[1] // 2) * 2
    return x[:, :t].reshape(x.shape[0], t // 2, 2, x.shape[2]).mean(dim=2)


def upfirdn1d(x: torch.Tensor, kernel: Sequence[float], up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-stuff by `up`, pad T by `pad` (negative: crop), convolve with
    `kernel` (a true convolution: the kernel flipped), keep every `down`-th
    frame; as shifted adds of the short kernel."""
    k = list(kernel)[::-1]
    B, T, C = x.shape
    if up > 1:
        x = torch.cat([x[:, :, None, :], x.new_zeros((B, T, up - 1, C))], dim=2).reshape(B, T * up, C)
    p0, p1 = pad
    x = F.pad(x, (0, 0, max(p0, 0), max(p1, 0)))
    if p0 < 0:
        x = x[:, -p0:]
    if p1 < 0:
        x = x[:, :p1]
    n = x.shape[1] - len(k) + 1
    out = k[0] * x[:, 0:n]
    for i in range(1, len(k)):
        out = out + k[i] * x[:, i: i + n]
    return out[:, ::down] if down > 1 else out


_FIR = (1.0, 3.0, 3.0, 1.0)


def fir_up2(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """FIR x2 upsample with (1, 3, 3, 1), amplitude kept (gain factor x 2)."""
    k = [v / sum(_FIR) * gain * 2 for v in _FIR]
    p = len(k) - 2
    return upfirdn1d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def fir_down2(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    k = [v / sum(_FIR) * gain for v in _FIR]
    p = len(k) - 2
    return upfirdn1d(x, k, down=2, pad=((p + 1) // 2, p // 2))


def _reflect1(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x.transpose(1, 2), (1, 1), mode="reflect").transpose(1, 2)


def k_down2(x: torch.Tensor) -> torch.Tensor:
    """KDownsample: reflect-pad 1, correlate with (1, 3, 3, 1) / 8, stride 2
    (the kernel is symmetric, so correlation is convolution)."""
    return upfirdn1d(_reflect1(x), [v / 8.0 for v in _FIR], down=2)


def k_up2(x: torch.Tensor) -> torch.Tensor:
    """KUpsample: reflect-pad 1, transposed conv stride 2 with (1, 3, 3, 1) / 4
    and padding 3, which is zero-stuffing, a full convolution and a crop of 3."""
    k = [v / 8.0 * 2.0 for v in _FIR]
    return upfirdn1d(_reflect1(x), k, up=2, pad=(len(k) - 1 - 3, len(k) - 2 - 3))


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
        return self.conv(nearest_up2(x))


class FirDownsample1D(nn.Module):
    """FirDownsample2D: the FIR x2 downsample, or with `use_conv` the FIR
    filter padded for a k3 stride-2 conv (`Conv1d_0`)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, use_conv: bool = False):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.Conv1d_0 = _StridedConv(in_channels, out_channels or in_channels, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_conv:
            return fir_down2(x)
        k = [v / sum(_FIR) for v in _FIR]
        p = (len(k) - 2) + 2  # (kernel - factor) + (conv width - 1)
        return self.Conv1d_0(upfirdn1d(x, k, pad=((p + 1) // 2, p // 2)))


class FirUpsample1D(nn.Module):
    """FirUpsample2D: the FIR x2 upsample, then with `use_conv` a k3 conv."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, use_conv: bool = False):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.Conv1d_0 = Conv1dSame(in_channels, out_channels or in_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv1d_0(fir_up2(x)) if self.use_conv else fir_up2(x)


# --------------------------------------------------------------------------
# norms and attention
# --------------------------------------------------------------------------


class AdaGroupNorm1D(nn.Module):
    """AdaGroupNorm: a GroupNorm without affine parameters, modulated by a
    per-batch (scale, shift) projected from the time embedding (`linear`,
    `emb_channels` in)."""

    def __init__(self, emb_channels: int, out_dim: int, num_groups: int, eps: float = 1e-5,
                 act_fn: Optional[str] = None):
        super().__init__()
        self.act = get_activation(act_fn) if act_fn is not None else None
        self.linear = Dense(emb_channels, 2 * out_dim)
        self.norm = GroupNorm(num_groups, out_dim, eps=eps, affine=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.act is not None:
            emb = self.act(emb)
        scale, shift = self.linear(emb)[:, None, :].chunk(2, dim=-1)
        return self.norm(x).to(self.linear.compute_dtype) * (1 + scale) + shift


def _context_norm(kind: Optional[str], width: int, groups: int) -> Optional[nn.Module]:
    """The `norm_cross` of a cross-attention_norm kind over `width` features."""
    if kind == "layer_norm":
        return LayerNorm(width)
    if kind == "group_norm":
        return GroupNorm(groups, width, eps=1e-5)
    return None


class CrossAttention1D(nn.Module):
    """diffusers `Attention` core on channels-last inputs: q from x, k/v from
    `context` (`cross_attention_dim` features; self-attention on x when
    context is None, then x must have that width), the context first
    normed by `norm_cross` when `cross_attention_norm` is 'layer_norm' or
    'group_norm' (build it so only for calls with a context).  `bias_add`
    is an additive attention bias; with one, `dot_product_attention` takes
    its plain path whatever `attn_impl`, as in the JAX package."""

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
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        norm = _context_norm(cross_attention_norm, ctx_dim, cross_attention_norm_num_groups)
        if norm is not None:
            self.norm_cross = norm
        self.to_q = Dense(query_dim, inner, bias=bias)
        self.to_k = Dense(ctx_dim, inner, bias=bias)
        self.to_v = Dense(ctx_dim, inner, bias=bias)
        self.to_out_0 = Dense(inner, query_dim, bias=out_bias)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                bias_add: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        if context is not None and hasattr(self, "norm_cross"):
            ctx = self.norm_cross(ctx).to(self.to_k.compute_dtype)
        B, Tq, Tk = x.shape[0], x.shape[1], ctx.shape[1]
        out = dot_product_attention(
            self.to_q(x).reshape(B, Tq, self.heads, self.dim_head),
            self.to_k(ctx).reshape(B, Tk, self.heads, self.dim_head),
            self.to_v(ctx).reshape(B, Tk, self.heads, self.dim_head),
            bias=bias_add,
            impl=self.attn_impl,
        ).reshape(B, Tq, self.heads * self.dim_head)
        return self.to_out_0(out)


class AttnBlock1D(nn.Module):
    """The deprecated-style `Attention` of the Attn*Block2D types: group norm,
    self-attention over T in heads of `attention_head_dim` (all channels
    one head when None), a residual and `rescale_output_factor`; q, k, v and
    out have biases and sit on the block itself."""

    def __init__(
        self,
        channels: int,
        attention_head_dim: Optional[int] = None,
        norm_num_groups: Optional[int] = 32,
        eps: float = 1e-5,
        rescale_output_factor: float = 1.0,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.head_dim = attention_head_dim or channels
        self.heads = channels // self.head_dim
        self.rescale_output_factor, self.attn_impl = rescale_output_factor, attn_impl
        if norm_num_groups is not None:
            self.group_norm = GroupNorm(norm_num_groups, channels, eps=eps)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out_0 = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.group_norm(x).to(self.to_q.compute_dtype) if hasattr(self, "group_norm") else x
        B, T, C = h.shape
        shape = (B, T, self.heads, self.head_dim)
        h = dot_product_attention(self.to_q(h).reshape(shape), self.to_k(h).reshape(shape),
                                  self.to_v(h).reshape(shape), impl=self.attn_impl).reshape(B, T, C)
        return (x + self.to_out_0(h)) / self.rescale_output_factor


class AddedKVAttention1D(nn.Module):
    """`Attention` with added K/V projections (`AttnAddedKVProcessor`): q
    from the group-normed x, `add_k_proj` / `add_v_proj` of the encoder
    states prepended along the key axis to the self k/v of the normed x
    (`only_cross_attention` keeps the added ones alone).  Without encoder
    states the added projections read the *un-normed* x (the reference binds
    it before group_norm).  `context_dim` is the encoder states' width (None:
    called without them); `added_kv_proj_dim` is kept for the JAX
    signature.  `norm_cross` (layer_norm, or group_norm with 32 groups)
    normalises the encoder states."""

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        added_kv_proj_dim: Optional[int] = None,
        norm_num_groups: Optional[int] = None,
        only_cross_attention: bool = False,
        cross_attention_norm: Optional[str] = None,
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        inner = heads * dim_head
        kv_in = context_dim or query_dim
        self.heads, self.dim_head, self.attn_impl = heads, dim_head, attn_impl
        self.only_cross_attention = only_cross_attention
        norm = _context_norm(cross_attention_norm, kv_in, 32) if context_dim is not None else None
        if norm is not None:
            self.norm_cross = norm
        if norm_num_groups is not None:
            self.group_norm = GroupNorm(norm_num_groups, query_dim, eps=1e-5)
        self.to_q = Dense(query_dim, inner)
        self.add_k_proj = Dense(kv_in, inner)
        self.add_v_proj = Dense(kv_in, inner)
        if not only_cross_attention:
            self.to_k = Dense(query_dim, inner)
            self.to_v = Dense(query_dim, inner)
        self.to_out_0 = Dense(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                bias_add: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.to_q.compute_dtype
        ctx = x if context is None else context
        if context is not None and hasattr(self, "norm_cross"):
            ctx = self.norm_cross(ctx).to(dtype)
        h = self.group_norm(x).to(dtype) if hasattr(self, "group_norm") else x
        k, v = self.add_k_proj(ctx), self.add_v_proj(ctx)
        if not self.only_cross_attention:
            k = torch.cat([k, self.to_k(h)], dim=1)
            v = torch.cat([v, self.to_v(h)], dim=1)
        B, Tq, Tk = x.shape[0], x.shape[1], k.shape[1]
        out = dot_product_attention(
            self.to_q(h).reshape(B, Tq, self.heads, self.dim_head),
            k.reshape(B, Tk, self.heads, self.dim_head),
            v.reshape(B, Tk, self.heads, self.dim_head),
            bias=bias_add,
            impl=self.attn_impl,
        ).reshape(B, Tq, self.heads * self.dim_head)
        return self.to_out_0(out) + x


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


class DualTransformer1D(nn.Module):
    """DualTransformer2DModel: two transformers (`transformers_0`, `_1`),
    each over its token slice of the context (`condition_lengths`, routed
    by `transformer_index_for_condition`), mixed `mix_ratio` : 1 - mix_ratio
    around the shared residual.  Its transformers take the plain attention,
    as the JAX module's do."""

    def __init__(
        self,
        num_attention_heads: int,
        attention_head_dim: int,
        in_channels: int,
        num_layers: int = 1,
        cross_attention_dim: Optional[int] = None,
        norm_num_groups: int = 32,
        condition_lengths: Tuple[int, int] = (77, 257),
        transformer_index_for_condition: Tuple[int, int] = (1, 0),
        mix_ratio: float = 0.5,
    ):
        super().__init__()
        self.condition_lengths = tuple(condition_lengths)
        self.transformer_index_for_condition = tuple(transformer_index_for_condition)
        self.mix_ratio = mix_ratio
        for i in range(2):
            self.add_module(f"transformers_{i}", Transformer1D(
                num_attention_heads, attention_head_dim, in_channels, num_layers=num_layers,
                cross_attention_dim=cross_attention_dim, norm_num_groups=norm_num_groups))

    def forward(self, x: torch.Tensor, context: torch.Tensor, bias_add=None) -> torch.Tensor:
        encoded, start = [], 0
        for i, length in enumerate(self.condition_lengths):
            block = getattr(self, f"transformers_{self.transformer_index_for_condition[i]}")
            encoded.append(block(x, context[:, start: start + length], bias_add=bias_add) - x)
            start += length
        return encoded[0] * self.mix_ratio + encoded[1] * (1 - self.mix_ratio) + x


class KAttention1D(nn.Module):
    """KAttentionBlock: an AdaGroupNorm-gated self-attention (with
    `add_self_attention`), then an AdaGroupNorm-gated cross-attention over
    the encoder states (`context_dim` wide; self-attention over x when the
    block is called without them), no feed-forward."""

    def __init__(
        self,
        dim: int,
        num_attention_heads: int,
        attention_head_dim: int,
        cross_attention_dim: Optional[int] = None,
        temb_channels: int = 768,
        add_self_attention: bool = False,
        attention_bias: bool = True,
        cross_attention_norm: Optional[str] = None,
        group_size: int = 32,
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        groups = max(1, dim // group_size)
        if add_self_attention:
            self.norm1 = AdaGroupNorm1D(temb_channels, dim, groups)
            self.attn1 = CrossAttention1D(dim, num_attention_heads, attention_head_dim, bias=attention_bias,
                                          attn_impl=attn_impl)
        self.norm2 = AdaGroupNorm1D(temb_channels, dim, groups)
        self.attn2 = CrossAttention1D(
            dim, num_attention_heads, attention_head_dim, cross_attention_dim=context_dim, bias=attention_bias,
            cross_attention_norm=cross_attention_norm if context_dim is not None else None, attn_impl=attn_impl)

    def forward(self, x, temb, context=None, bias_add=None, context_bias_add=None) -> torch.Tensor:
        if hasattr(self, "attn1"):
            x = x + self.attn1(self.norm1(x, temb), None, bias_add=bias_add)
        return x + self.attn2(self.norm2(x, temb), context,
                              bias_add=bias_add if context is None else context_bias_add)


# --------------------------------------------------------------------------
# resnet
# --------------------------------------------------------------------------

_UP = {"fir": fir_up2, "sde_vp": nearest_up2, None: nearest_up2}
_DOWN = {"fir": fir_down2, "sde_vp": avg_down2, None: avg_down2}


class ResnetBlock1DFull(nn.Module):
    """ResnetBlock2D in 1-D: time_embedding_norm 'default' (the time
    projection added after conv1), 'scale_shift' (h * (1 + scale) + shift
    after norm2) or 'ada_group' (both norms `AdaGroupNorm1D`, no time
    projection); `up` / `down` resample x and the normed h before conv1
    (`kernel` None or 'sde_vp': nearest / avg-pool, 'fir': the FIR filters);
    skip_time_act, output_scale_factor, a forced or bias-free shortcut and a
    distinct conv2 width (`conv_out_channels`)."""

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
        if kernel not in _UP:
            raise ValueError(f"kernel must be None, 'fir' or 'sde_vp', got {kernel!r}")
        conv_out_ch = conv_out_channels or out_channels
        groups_out = groups_out if groups_out is not None else groups
        self.act = get_activation(non_linearity)
        self.skip_time_act = skip_time_act
        self.time_embedding_norm = time_embedding_norm
        self.output_scale_factor = output_scale_factor
        self.resample = _UP[kernel] if up else _DOWN[kernel] if down else None
        self.ada = time_embedding_norm == "ada_group"
        if self.ada:
            self.norm1 = AdaGroupNorm1D(temb_channels, in_channels, groups, eps=eps)
        else:
            self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv1dSame(in_channels, out_channels, 3)
        if temb_channels is not None and not self.ada:
            width = 2 * out_channels if time_embedding_norm == "scale_shift" else out_channels
            self.time_emb_proj = Dense(temb_channels, width)
        if self.ada:
            self.norm2 = AdaGroupNorm1D(temb_channels, out_channels, groups_out, eps=eps)
        else:
            self.norm2 = GroupNorm(groups_out, out_channels, eps=eps)
        self.conv2 = Conv1dSame(out_channels, conv_out_ch, 3)
        use_sc = in_channels != conv_out_ch if use_in_shortcut is None else use_in_shortcut
        if use_sc:
            self.conv_shortcut = Conv1dSame(in_channels, conv_out_ch, 1, bias=conv_shortcut_bias)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.conv1.compute_dtype
        h = self.norm1(x, temb) if self.ada else self.norm1(x).to(dtype)
        h = self.act(h)
        if self.resample is not None:
            x, h = self.resample(x), self.resample(h)
        h = self.conv1(h)
        emb = None
        if temb is not None and hasattr(self, "time_emb_proj"):
            emb = self.time_emb_proj(temb if self.skip_time_act else self.act(temb))[:, None, :]
        if emb is not None and self.time_embedding_norm == "default":
            h = h + emb
        h = self.norm2(h, temb) if self.ada else self.norm2(h).to(dtype)
        if emb is not None and self.time_embedding_norm == "scale_shift":
            scale, shift = emb.chunk(2, dim=-1)
            h = h * (1 + scale) + shift
        h = self.conv2(self.act(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return (x + h) / self.output_scale_factor


# --------------------------------------------------------------------------
# down blocks
# --------------------------------------------------------------------------


def _resnets(module: nn.Module, in_widths: Sequence[int], out_channels: int, temb_channels, groups, eps,
             act_fn, time_scale_shift, output_scale_factor, skip_time_act: bool = False) -> None:
    for i, width in enumerate(in_widths):
        module.add_module(f"resnets_{i}", ResnetBlock1DFull(
            width, out_channels, temb_channels, groups=groups, eps=eps, non_linearity=act_fn,
            time_embedding_norm=time_scale_shift, output_scale_factor=output_scale_factor,
            skip_time_act=skip_time_act,
        ))


def _down_widths(in_channels: int, out_channels: int, num_layers: int) -> list:
    return [in_channels] + [out_channels] * (num_layers - 1)


def _transformer(out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                 resnet_groups, dual_cross_attention, only_cross_attention, attn_impl) -> nn.Module:
    if dual_cross_attention:
        return DualTransformer1D(num_attention_heads, out_channels // num_attention_heads, out_channels,
                                 num_layers=1, cross_attention_dim=cross_attention_dim,
                                 norm_num_groups=resnet_groups)
    return Transformer1D(
        num_attention_heads, out_channels // num_attention_heads, out_channels,
        num_layers=transformer_layers_per_block, cross_attention_dim=cross_attention_dim,
        norm_num_groups=resnet_groups, only_cross_attention=only_cross_attention, attn_impl=attn_impl,
    )


def _run_attention(attn: nn.Module, x, context, bias_add, context_bias_add):
    if isinstance(attn, DualTransformer1D):
        return attn(x, context, bias_add=context_bias_add)
    return attn(x, context, bias_add, context_bias_add)


class DownBlock1D(nn.Module):
    """DownBlock2D: resnets, each output a skip, then the strided-conv
    downsampler (its output a skip too).  `skip_widths` (every down block
    has it) lists the width of each skip it emits, None for a None skip."""

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
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        if add_downsample:
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)
        self.skip_widths = (out_channels,) * (num_layers + int(add_downsample))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips += (x,)
        return x, skips


class ResnetDownsampleBlock1D(nn.Module):
    """ResnetDownsampleBlock2D: resnets, then a down=True resnet (avg-pool
    over T) as the downsampler."""

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
        skip_time_act: bool = False,
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor,
                 skip_time_act)
        if add_downsample:
            self.downsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, skip_time_act=skip_time_act, down=True)
        self.skip_widths = (out_channels,) * (num_layers + int(add_downsample))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x, temb)
            skips += (x,)
        return x, skips


class AttnDownBlock1D(nn.Module):
    """AttnDownBlock2D: (resnet, `AttnBlock1D`) pairs, each pair's output a
    skip, then the conv downsampler or a down=True resnet
    (`downsample_type`)."""

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
        attention_head_dim: Optional[int] = 1,
        output_scale_factor: float = 1.0,
        downsample_padding: int = 1,
        downsample_type: Optional[str] = "conv",
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", AttnBlock1D(
                out_channels, attention_head_dim or out_channels, norm_num_groups=resnet_groups, eps=resnet_eps,
                rescale_output_factor=output_scale_factor, attn_impl=attn_impl))
        if downsample_type == "conv":
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)
        elif downsample_type == "resnet":
            self.downsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, down=True)
        self.skip_widths = (out_channels,) * (num_layers + int(hasattr(self, "downsamplers_0")))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"attentions_{i}")(getattr(self, f"resnets_{i}")(x, temb))
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            down = self.downsamplers_0
            x = down(x, temb) if isinstance(down, ResnetBlock1DFull) else down(x)
            skips += (x,)
        return x, skips


class CrossAttnDownBlock1D(nn.Module):
    """CrossAttnDownBlock2D: (resnet, transformer or dual transformer)
    pairs, each pair's output a skip (the adapter's `additional_residuals`
    added to the last pair's, so to that skip too), then the downsampler."""

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
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                resnet_groups, dual_cross_attention, only_cross_attention, attn_impl))
        if add_downsample:
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)
        self.skip_widths = (out_channels,) * (num_layers + int(add_downsample))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, context=None, bias_add=None,
                context_bias_add=None, additional_residuals=None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            x = _run_attention(getattr(self, f"attentions_{i}"), x, context, bias_add, context_bias_add)
            if additional_residuals is not None and i == self.num_layers - 1:
                x = x + additional_residuals
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips += (x,)
        return x, skips


class SimpleCrossAttnDownBlock1D(nn.Module):
    """SimpleCrossAttnDownBlock2D: (resnet, `AddedKVAttention1D`) pairs, then
    a down=True resnet; `context_dim` is the encoder states' width (None:
    called without them)."""

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
        attention_head_dim: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        add_downsample: bool = True,
        skip_time_act: bool = False,
        only_cross_attention: bool = False,
        cross_attention_norm: Optional[str] = None,
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor,
                 skip_time_act)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", AddedKVAttention1D(
                out_channels, out_channels // attention_head_dim, attention_head_dim,
                added_kv_proj_dim=cross_attention_dim, norm_num_groups=resnet_groups,
                only_cross_attention=only_cross_attention, cross_attention_norm=cross_attention_norm,
                attn_impl=attn_impl, context_dim=context_dim))
        if add_downsample:
            self.downsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, skip_time_act=skip_time_act, down=True)
        self.skip_widths = (out_channels,) * (num_layers + int(add_downsample))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, context=None, bias_add=None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            x = getattr(self, f"attentions_{i}")(x, context, bias_add=bias_add)
            skips += (x,)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x, temb)
            skips += (x,)
        return x, skips


class SkipDownBlock1D(nn.Module):
    """SkipDownBlock2D / AttnSkipDownBlock2D (`with_attention`): score-SDE
    style, a FIR pyramid of the raw input (`skip_channels` wide) rides
    alongside and joins through `skip_conv` after the FIR down-resnet
    (`resnet_down`)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        skip_channels: int = 1,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        output_scale_factor: float = 2.0 ** 0.5,
        add_downsample: bool = True,
        with_attention: bool = False,
        attention_head_dim: Optional[int] = 1,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers, self.with_attention = num_layers, with_attention
        for i, cin in enumerate(_down_widths(in_channels, out_channels, num_layers)):
            self.add_module(f"resnets_{i}", ResnetBlock1DFull(
                cin, out_channels, temb_channels, groups=min(cin // 4, 32), groups_out=min(out_channels // 4, 32),
                eps=resnet_eps, non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor))
            if with_attention:
                self.add_module(f"attentions_{i}", AttnBlock1D(
                    out_channels, attention_head_dim or out_channels, norm_num_groups=32, eps=resnet_eps,
                    rescale_output_factor=output_scale_factor, attn_impl=attn_impl))
        if add_downsample:
            self.resnet_down = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=min(out_channels // 4, 32), eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, use_in_shortcut=True, down=True, kernel="fir")
            self.skip_conv = Conv1dSame(skip_channels, out_channels, 1)
        self.skip_widths = (out_channels,) * (num_layers + int(add_downsample))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, skip_sample=None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.with_attention:
                x = getattr(self, f"attentions_{i}")(x)
            skips += (x,)
        if hasattr(self, "resnet_down"):
            x = self.resnet_down(x, temb)
            skip_sample = fir_down2(skip_sample)
            x = self.skip_conv(skip_sample) + x
            skips += (x,)
        return x, skips, skip_sample


class DownEncoderBlock1D(nn.Module):
    """DownEncoderBlock2D / AttnDownEncoderBlock2D (`with_attention`): no time
    conditioning, no skips (VAE-encoder style)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_downsample: bool = True,
        downsample_padding: int = 1,
        with_attention: bool = False,
        attention_head_dim: Optional[int] = 1,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers, self.with_attention = num_layers, with_attention
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, None,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        if with_attention:
            for i in range(num_layers):
                self.add_module(f"attentions_{i}", AttnBlock1D(
                    out_channels, attention_head_dim or out_channels, norm_num_groups=resnet_groups, eps=resnet_eps,
                    rescale_output_factor=output_scale_factor, attn_impl=attn_impl))
        if add_downsample:
            self.downsamplers_0 = ConvDownsample1D(out_channels, out_channels, downsample_padding)
        self.skip_widths = ()

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, None)
            if self.with_attention:
                x = getattr(self, f"attentions_{i}")(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
        return x, ()


def _k_resnet(in_channels, out_channels, temb_channels, group_size, eps, act_fn, conv_out_channels=None):
    return ResnetBlock1DFull(
        in_channels, out_channels, temb_channels, groups=in_channels // group_size,
        groups_out=out_channels // group_size, eps=eps, non_linearity=act_fn, time_embedding_norm="ada_group",
        conv_shortcut_bias=False, conv_out_channels=conv_out_channels)


class KDownBlock1D(nn.Module):
    """KDownBlock2D: ada_group resnets with bias-free shortcuts, each output
    a skip, then the k-filter downsample (`k_down2`)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 4,
        resnet_eps: float = 1e-5,
        resnet_act_fn: str = "gelu",
        resnet_group_size: int = 32,
        add_downsample: bool = False,
    ):
        super().__init__()
        self.num_layers, self.add_downsample = num_layers, add_downsample
        for i, cin in enumerate(_down_widths(in_channels, out_channels, num_layers)):
            self.add_module(f"resnets_{i}", _k_resnet(cin, out_channels, temb_channels, resnet_group_size,
                                                      resnet_eps, resnet_act_fn))
        self.skip_widths = (out_channels,) * num_layers

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            skips += (x,)
        return (k_down2(x) if self.add_downsample else x), skips


class KCrossAttnDownBlock1D(nn.Module):
    """KCrossAttnDownBlock2D: (ada_group resnet, `KAttention1D`) pairs, then
    `k_down2`; the pairs' outputs are its skips when it downsamples, None
    skips otherwise (the k-unet consumes only the pre-downsample feature).
    `context_dim` is the encoder states' width (None: called without)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        cross_attention_dim: Optional[int] = None,
        num_layers: int = 4,
        resnet_group_size: int = 32,
        add_downsample: bool = True,
        attention_head_dim: int = 64,
        add_self_attention: bool = False,
        resnet_eps: float = 1e-5,
        resnet_act_fn: str = "gelu",
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        self.num_layers, self.add_downsample = num_layers, add_downsample
        for i, cin in enumerate(_down_widths(in_channels, out_channels, num_layers)):
            self.add_module(f"resnets_{i}", _k_resnet(cin, out_channels, temb_channels, resnet_group_size,
                                                      resnet_eps, resnet_act_fn))
            self.add_module(f"attentions_{i}", KAttention1D(
                out_channels, out_channels // attention_head_dim, attention_head_dim,
                cross_attention_dim=cross_attention_dim, temb_channels=temb_channels, attention_bias=True,
                add_self_attention=add_self_attention, cross_attention_norm="layer_norm",
                group_size=resnet_group_size, attn_impl=attn_impl, context_dim=context_dim))
        self.skip_widths = (out_channels if add_downsample else None,) * num_layers

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, context=None, bias_add=None,
                context_bias_add=None):
        skips = ()
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            x = getattr(self, f"attentions_{i}")(x, temb, context, bias_add, context_bias_add)
            skips += (x if self.add_downsample else None,)
        return (k_down2(x) if self.add_downsample else x), skips


# --------------------------------------------------------------------------
# up blocks
# --------------------------------------------------------------------------


def _up_widths(in_channels: int, prev_output_channel: int, out_channels: int, num_layers: int,
               res_skip_channels: Optional[Sequence[int]] = None) -> list:
    """Input width of each resnet of an up block: the running hidden state
    (prev_output_channel, then out_channels) plus the skip it concatenates,
    `res_skip_channels[i]` (by default out_channels, and in_channels for the
    last, as diffusers builds it)."""
    if res_skip_channels is None:
        res_skip_channels = [in_channels if i == num_layers - 1 else out_channels for i in range(num_layers)]
    return [(prev_output_channel if i == 0 else out_channels) + res_skip_channels[i] for i in range(num_layers)]


def _pop_concat(x: torch.Tensor, skips: list) -> torch.Tensor:
    return torch.cat([x, skips.pop()], dim=-1)


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
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        _resnets(self, widths, out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor)
        if add_upsample:
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class ResnetUpsampleBlock1D(nn.Module):
    """ResnetUpsampleBlock2D: per layer, concat a skip and a resnet; then an
    up=True resnet (nearest x2) as the upsampler."""

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
        skip_time_act: bool = False,
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        _resnets(self, widths, out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor, skip_time_act)
        if add_upsample:
            self.upsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, skip_time_act=skip_time_act, up=True)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x, temb)
        return x


class AttnUpBlock1D(nn.Module):
    """AttnUpBlock2D: per layer, concat a skip, a resnet and an `AttnBlock1D`;
    then the conv upsampler or an up=True resnet (`upsample_type`)."""

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
        attention_head_dim: Optional[int] = 1,
        output_scale_factor: float = 1.0,
        upsample_type: Optional[str] = "conv",
        attn_impl: str = "xla",
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        _resnets(self, widths, out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", AttnBlock1D(
                out_channels, attention_head_dim or out_channels, norm_num_groups=resnet_groups, eps=resnet_eps,
                rescale_output_factor=output_scale_factor, attn_impl=attn_impl))
        if upsample_type == "conv":
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)
        elif upsample_type == "resnet":
            self.upsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, up=True)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
            x = getattr(self, f"attentions_{i}")(x)
        if hasattr(self, "upsamplers_0"):
            up = self.upsamplers_0
            x = up(x, temb) if isinstance(up, ResnetBlock1DFull) else up(x)
        return x


class CrossAttnUpBlock1D(nn.Module):
    """CrossAttnUpBlock2D: per layer, concat one popped skip, a resnet and a
    transformer (or dual transformer); then the upsampler."""

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
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        _resnets(self, widths, out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                out_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                resnet_groups, dual_cross_attention, only_cross_attention, attn_impl))
        if add_upsample:
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None, context=None, bias_add=None,
                context_bias_add=None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
            x = _run_attention(getattr(self, f"attentions_{i}"), x, context, bias_add, context_bias_add)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class SimpleCrossAttnUpBlock1D(nn.Module):
    """SimpleCrossAttnUpBlock2D: per layer, concat a skip, a resnet and an
    `AddedKVAttention1D`; then an up=True resnet."""

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
        attention_head_dim: int = 1,
        cross_attention_dim: int = 1280,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
        skip_time_act: bool = False,
        only_cross_attention: bool = False,
        cross_attention_norm: Optional[str] = None,
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        _resnets(self, widths, out_channels,
                 temb_channels, resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift,
                 output_scale_factor, skip_time_act)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", AddedKVAttention1D(
                out_channels, out_channels // attention_head_dim, attention_head_dim,
                added_kv_proj_dim=cross_attention_dim, norm_num_groups=resnet_groups,
                only_cross_attention=only_cross_attention, cross_attention_norm=cross_attention_norm,
                attn_impl=attn_impl, context_dim=context_dim))
        if add_upsample:
            self.upsamplers_0 = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=resnet_groups, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, skip_time_act=skip_time_act, up=True)

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None, context=None,
                bias_add=None) -> torch.Tensor:
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
            x = getattr(self, f"attentions_{i}")(x, context, bias_add=bias_add)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x, temb)
        return x


class SkipUpBlock1D(nn.Module):
    """SkipUpBlock2D / AttnSkipUpBlock2D (`with_attention`): per layer, concat
    a skip and a resnet (groups min(C // 4, 32) of the concatenated width,
    for both types); one `AttnBlock1D` after them; the score-SDE skip sample
    FIR-upsampled (0.0 when the block receives None) plus
    `skip_conv(silu(skip_norm(h)))`, then the FIR up-resnet `resnet_up`.
    Returns (x, skip_sample)."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: Optional[int],
        skip_channels: int = 1,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        output_scale_factor: float = 2.0 ** 0.5,
        add_upsample: bool = True,
        with_attention: bool = False,
        attention_head_dim: Optional[int] = 1,
        attn_impl: str = "xla",
        res_skip_channels: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        groups_out = min(out_channels // 4, 32)
        widths = _up_widths(in_channels, prev_output_channel, out_channels, num_layers, res_skip_channels)
        for i, cin in enumerate(widths):
            self.add_module(f"resnets_{i}", ResnetBlock1DFull(
                cin, out_channels, temb_channels, groups=min(cin // 4, 32), groups_out=groups_out, eps=resnet_eps,
                non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor))
        if with_attention:
            self.attentions_0 = AttnBlock1D(
                out_channels, attention_head_dim or out_channels, norm_num_groups=32, eps=resnet_eps,
                rescale_output_factor=output_scale_factor, attn_impl=attn_impl)
        if add_upsample:
            self.skip_norm = GroupNorm(groups_out, out_channels, eps=resnet_eps)
            self.skip_conv = Conv1dSame(out_channels, skip_channels, 3)
            self.resnet_up = ResnetBlock1DFull(
                out_channels, out_channels, temb_channels, groups=groups_out, groups_out=groups_out,
                eps=resnet_eps, non_linearity=resnet_act_fn, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, use_in_shortcut=True, up=True, kernel="fir")

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None, skip_sample=None):
        skips = list(skips)
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(_pop_concat(x, skips), temb)
        if hasattr(self, "attentions_0"):
            x = self.attentions_0(x)
        skip_sample = fir_up2(skip_sample) if skip_sample is not None else 0.0
        if hasattr(self, "resnet_up"):
            s = F.silu(self.skip_norm(x).to(self.skip_conv.compute_dtype))
            skip_sample = skip_sample + self.skip_conv(s)
            x = self.resnet_up(x, temb)
        return x, skip_sample


class UpDecoderBlock1D(nn.Module):
    """UpDecoderBlock2D / AttnUpDecoderBlock2D (`with_attention`): resnets
    (and `AttnBlock1D`s), no skips, then the conv upsampler (VAE-decoder
    style); `in_channels` is the width of the hidden state it receives."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = None,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: int = 32,
        output_scale_factor: float = 1.0,
        add_upsample: bool = True,
        with_attention: bool = False,
        attention_head_dim: Optional[int] = 1,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers, self.with_attention = num_layers, with_attention
        _resnets(self, _down_widths(in_channels, out_channels, num_layers), out_channels, temb_channels,
                 resnet_groups, resnet_eps, resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        if with_attention:
            for i in range(num_layers):
                self.add_module(f"attentions_{i}", AttnBlock1D(
                    out_channels, attention_head_dim or out_channels, norm_num_groups=resnet_groups, eps=resnet_eps,
                    rescale_output_factor=output_scale_factor, attn_impl=attn_impl))
        if add_upsample:
            self.upsamplers_0 = ConvUpsample1D(out_channels, out_channels)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.with_attention:
                x = getattr(self, f"attentions_{i}")(x)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


def _k_concat(x: torch.Tensor, skips) -> torch.Tensor:
    if skips and skips[-1] is not None:
        x = torch.cat([x, skips[-1]], dim=-1)
    return x


def _k_in_channels(prev_output_channel: Optional[int], out_channels: int,
                   res_skip_channels: Optional[Sequence[Optional[int]]]) -> int:
    """The width after a K up block's concatenation: the hidden state plus
    the last skip (`res_skip_channels[0]`, the first popped; None: no
    skip), by default prev_output_channel (or out_channels) plus a skip of
    out_channels."""
    skip = res_skip_channels[0] if res_skip_channels else out_channels
    return (prev_output_channel or out_channels) + (skip or 0)


class KUpBlock1D(nn.Module):
    """KUpBlock2D: the k-unet wiring, one skip (the last) concatenated up
    front, num_layers - 1 ada_group resnets of which the last maps to
    `in_channels`, then `k_up2`.  `prev_output_channel` and
    `res_skip_channels` give the width after the concatenation (flax infers
    it; `_k_in_channels`)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 5,
        resnet_eps: float = 1e-5,
        resnet_act_fn: str = "gelu",
        resnet_group_size: int = 32,
        add_upsample: bool = True,
        prev_output_channel: Optional[int] = None,
        res_skip_channels: Optional[Sequence[Optional[int]]] = None,
    ):
        super().__init__()
        self.n, self.add_upsample = num_layers - 1, add_upsample
        cin = _k_in_channels(prev_output_channel, out_channels, res_skip_channels)
        for i in range(self.n):
            width = in_channels if i == self.n - 1 else out_channels
            self.add_module(f"resnets_{i}", ResnetBlock1DFull(
                cin, width, temb_channels, groups=cin // resnet_group_size,
                groups_out=out_channels // resnet_group_size, eps=resnet_eps, non_linearity=resnet_act_fn,
                time_embedding_norm="ada_group", conv_shortcut_bias=False))
            cin = width

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _k_concat(x, skips)
        for i in range(self.n):
            x = getattr(self, f"resnets_{i}")(x, temb)
        return k_up2(x) if self.add_upsample else x


class KCrossAttnUpBlock1D(nn.Module):
    """KCrossAttnUpBlock2D: the k-unet wiring as `KUpBlock1D`, each resnet
    followed by a `KAttention1D` (self-attention too in the first block,
    where in, out and time widths agree); a middle block's last resnet maps
    to `in_channels` through conv2.  `context_dim` is the encoder states'
    width (None: called without them); the input width as in `KUpBlock1D`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        cross_attention_dim: int = 768,
        num_layers: int = 4,
        resnet_eps: float = 1e-5,
        resnet_act_fn: str = "gelu",
        resnet_group_size: int = 32,
        attention_head_dim: int = 1,
        add_upsample: bool = True,
        attn_impl: str = "xla",
        prev_output_channel: Optional[int] = None,
        res_skip_channels: Optional[Sequence[Optional[int]]] = None,
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        is_first = in_channels == out_channels == temb_channels
        is_middle = in_channels != out_channels
        self.n, self.add_upsample = num_layers - 1, add_upsample
        cin = _k_in_channels(prev_output_channel, out_channels, res_skip_channels)
        for i in range(self.n):
            last = i == self.n - 1
            conv_out = in_channels if (is_middle and last) else None
            self.add_module(f"resnets_{i}", _k_resnet(cin, out_channels, temb_channels, resnet_group_size,
                                                      resnet_eps, resnet_act_fn, conv_out))
            dim = in_channels if last else out_channels
            self.add_module(f"attentions_{i}", KAttention1D(
                dim, dim // attention_head_dim, attention_head_dim, cross_attention_dim=cross_attention_dim,
                temb_channels=temb_channels, attention_bias=True, add_self_attention=is_first,
                cross_attention_norm="layer_norm", attn_impl=attn_impl, context_dim=context_dim))
            cin = conv_out or out_channels

    def forward(self, x: torch.Tensor, skips, temb: Optional[torch.Tensor] = None, context=None, bias_add=None,
                context_bias_add=None) -> torch.Tensor:
        x = _k_concat(x, skips)
        for i in range(self.n):
            x = getattr(self, f"resnets_{i}")(x, temb)
            x = getattr(self, f"attentions_{i}")(x, temb, context, bias_add, context_bias_add)
        return k_up2(x) if self.add_upsample else x


# --------------------------------------------------------------------------
# mid blocks
# --------------------------------------------------------------------------


def _mid_groups(resnet_groups: Optional[int], in_channels: int) -> int:
    return resnet_groups if resnet_groups is not None else min(in_channels // 4, 32)


class MidBlock1D(nn.Module):
    """UNetMidBlock2D: resnet, then num_layers x (`AttnBlock1D`, resnet)."""

    def __init__(
        self,
        in_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: Optional[int] = 32,
        add_attention: bool = True,
        attention_head_dim: Optional[int] = 1,
        output_scale_factor: float = 1.0,
        attn_impl: str = "xla",
    ):
        super().__init__()
        self.num_layers = num_layers
        groups = _mid_groups(resnet_groups, in_channels)
        _resnets(self, [in_channels] * (num_layers + 1), in_channels, temb_channels, groups, resnet_eps,
                 resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        if add_attention:
            for i in range(num_layers):
                self.add_module(f"attentions_{i}", AttnBlock1D(
                    in_channels, attention_head_dim or in_channels, norm_num_groups=groups, eps=resnet_eps,
                    rescale_output_factor=output_scale_factor, attn_impl=attn_impl))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.resnets_0(x, temb)
        for i in range(self.num_layers):
            if hasattr(self, f"attentions_{i}"):
                x = getattr(self, f"attentions_{i}")(x)
            x = getattr(self, f"resnets_{i + 1}")(x, temb)
        return x


class MidBlock1DCrossAttn(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet, then (transformer or dual
    transformer, resnet) pairs."""

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
        groups = _mid_groups(resnet_groups, in_channels)
        _resnets(self, [in_channels] * (num_layers + 1), in_channels, temb_channels, groups, resnet_eps,
                 resnet_act_fn, resnet_time_scale_shift, output_scale_factor)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", _transformer(
                in_channels, num_attention_heads, transformer_layers_per_block, cross_attention_dim,
                groups, dual_cross_attention, only_cross_attention, attn_impl))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, context=None, bias_add=None,
                context_bias_add=None) -> torch.Tensor:
        x = self.resnets_0(x, temb)
        for i in range(self.num_layers):
            x = _run_attention(getattr(self, f"attentions_{i}"), x, context, bias_add, context_bias_add)
            x = getattr(self, f"resnets_{i + 1}")(x, temb)
        return x


class MidBlock1DSimpleCrossAttn(nn.Module):
    """UNetMidBlock2DSimpleCrossAttn: resnet, then (`AddedKVAttention1D`,
    resnet) pairs; `context_dim` as in `SimpleCrossAttnDownBlock1D`."""

    def __init__(
        self,
        in_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_act_fn: str = "swish",
        resnet_groups: Optional[int] = 32,
        attention_head_dim: int = 1,
        output_scale_factor: float = 1.0,
        cross_attention_dim: int = 1280,
        skip_time_act: bool = False,
        only_cross_attention: bool = False,
        cross_attention_norm: Optional[str] = None,
        attn_impl: str = "xla",
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        groups = _mid_groups(resnet_groups, in_channels)
        _resnets(self, [in_channels] * (num_layers + 1), in_channels, temb_channels, groups, resnet_eps,
                 resnet_act_fn, resnet_time_scale_shift, output_scale_factor, skip_time_act)
        for i in range(num_layers):
            self.add_module(f"attentions_{i}", AddedKVAttention1D(
                in_channels, in_channels // attention_head_dim, attention_head_dim,
                added_kv_proj_dim=cross_attention_dim, norm_num_groups=groups,
                only_cross_attention=only_cross_attention, cross_attention_norm=cross_attention_norm,
                attn_impl=attn_impl, context_dim=context_dim))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, context=None,
                bias_add=None) -> torch.Tensor:
        x = self.resnets_0(x, temb)
        for i in range(self.num_layers):
            x = getattr(self, f"attentions_{i}")(x, context, bias_add=bias_add)
            x = getattr(self, f"resnets_{i + 1}")(x, temb)
        return x


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------


def _norm_type(t: str) -> str:
    if t.startswith("UNetRes"):
        t = t[7:]
    return t.replace("1D", "2D")  # accept 1D aliases


def _kv_width(context_dim: Optional[int], cross_attention_dim: Optional[int], heads: int, width: int):
    """The k/v input width of a transformer's attentions: the encoder
    states', or without them the block's own inner width; None when the
    config has no cross-attention (then the transformer has no attn2)."""
    if cross_attention_dim is None:
        return None
    return context_dim if context_dim is not None else heads * (width // heads)


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
    context_dim: Optional[int] = None,
) -> nn.Module:
    """The JAX `get_down_block`: the same dispatch names and defaulting
    (attention_head_dim falls back to num_attention_heads).
    `use_linear_projection` and `upcast_attention` change nothing here, as in
    the JAX package.  `context_dim`: the width of the encoder states the
    block is called with (None: called without them)."""
    del use_linear_projection, upcast_attention
    if attention_head_dim is None:
        attention_head_dim = num_attention_heads
    t = _norm_type(down_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    pad = downsample_padding if downsample_padding is not None else 1
    common = dict(num_layers=num_layers, resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn)
    io = (in_channels, out_channels)
    if t == "DownBlock2D":
        return DownBlock1D(*io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
                           add_downsample=add_downsample, downsample_padding=pad, **common)
    if t == "ResnetDownsampleBlock2D":
        return ResnetDownsampleBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            add_downsample=add_downsample, skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor, **common)
    if t == "AttnDownBlock2D":
        ds = None if not add_downsample else (downsample_type or "conv")
        return AttnDownBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            attention_head_dim=attention_head_dim, downsample_padding=pad, downsample_type=ds,
            attn_impl=attn_impl, **common)
    if t == "CrossAttnDownBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnDownBlock2D")
        return CrossAttnDownBlock1D(
            *io, temb_channels, resnet_groups=groups, transformer_layers_per_block=transformer_layers_per_block,
            resnet_time_scale_shift=resnet_time_scale_shift, num_attention_heads=num_attention_heads,
            cross_attention_dim=_kv_width(context_dim, cross_attention_dim, num_attention_heads, out_channels),
            downsample_padding=pad, add_downsample=add_downsample, dual_cross_attention=dual_cross_attention,
            only_cross_attention=only_cross_attention, attn_impl=attn_impl, **common)
    if t == "SimpleCrossAttnDownBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for SimpleCrossAttnDownBlock2D")
        return SimpleCrossAttnDownBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            attention_head_dim=attention_head_dim, cross_attention_dim=cross_attention_dim,
            add_downsample=add_downsample, skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor, only_cross_attention=only_cross_attention,
            cross_attention_norm=cross_attention_norm, attn_impl=attn_impl, context_dim=context_dim, **common)
    if t in ("SkipDownBlock2D", "AttnSkipDownBlock2D"):
        attn = dict(with_attention=True, attention_head_dim=attention_head_dim, attn_impl=attn_impl) \
            if t == "AttnSkipDownBlock2D" else {}
        return SkipDownBlock1D(*io, temb_channels, skip_channels=skip_channels,
                               resnet_time_scale_shift=resnet_time_scale_shift, add_downsample=add_downsample,
                               **attn, **common)
    if t in ("DownEncoderBlock2D", "AttnDownEncoderBlock2D"):
        attn = dict(with_attention=True, attention_head_dim=attention_head_dim, attn_impl=attn_impl) \
            if t == "AttnDownEncoderBlock2D" else {}
        return DownEncoderBlock1D(*io, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
                                  add_downsample=add_downsample, downsample_padding=pad, **attn, **common)
    if t == "KDownBlock2D":
        return KDownBlock1D(*io, temb_channels, add_downsample=add_downsample, **common)
    if t == "KCrossAttnDownBlock2D":
        return KCrossAttnDownBlock1D(
            *io, temb_channels, cross_attention_dim=cross_attention_dim, add_downsample=add_downsample,
            attention_head_dim=attention_head_dim or 64, add_self_attention=not add_downsample,
            attn_impl=attn_impl, context_dim=context_dim, **common)
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
    context_dim: Optional[int] = None,
    res_skip_channels: Optional[Sequence[Optional[int]]] = None,
) -> nn.Module:
    """The JAX `get_up_block`.  `prev_output_channel` is the width of the
    hidden state the block receives; `context_dim` as in `get_down_block`;
    `res_skip_channels` the width of each skip the block concatenates, in
    order (None: the diffusers rule, out_channels and in_channels for the
    last; a K block concatenates only the first, None for a None skip)."""
    del use_linear_projection, upcast_attention
    if attention_head_dim is None:
        attention_head_dim = num_attention_heads
    t = _norm_type(up_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    common = dict(num_layers=num_layers, resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn)
    io = (in_channels, prev_output_channel, out_channels)
    skip = dict(res_skip_channels=res_skip_channels)
    if t == "UpBlock2D":
        return UpBlock1D(*io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
                         add_upsample=add_upsample, **skip, **common)
    if t == "ResnetUpsampleBlock2D":
        return ResnetUpsampleBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            add_upsample=add_upsample, skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor, **skip, **common)
    if t == "CrossAttnUpBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnUpBlock2D")
        return CrossAttnUpBlock1D(
            *io, temb_channels, resnet_groups=groups, transformer_layers_per_block=transformer_layers_per_block,
            resnet_time_scale_shift=resnet_time_scale_shift, num_attention_heads=num_attention_heads,
            cross_attention_dim=_kv_width(context_dim, cross_attention_dim, num_attention_heads, out_channels),
            add_upsample=add_upsample, dual_cross_attention=dual_cross_attention,
            only_cross_attention=only_cross_attention, attn_impl=attn_impl, **skip, **common)
    if t == "SimpleCrossAttnUpBlock2D":
        if cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for SimpleCrossAttnUpBlock2D")
        return SimpleCrossAttnUpBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            attention_head_dim=attention_head_dim, cross_attention_dim=cross_attention_dim,
            add_upsample=add_upsample, skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor, only_cross_attention=only_cross_attention,
            cross_attention_norm=cross_attention_norm, attn_impl=attn_impl, context_dim=context_dim, **skip,
            **common)
    if t == "AttnUpBlock2D":
        us = None if not add_upsample else (upsample_type or "conv")
        return AttnUpBlock1D(
            *io, temb_channels, resnet_groups=groups, resnet_time_scale_shift=resnet_time_scale_shift,
            attention_head_dim=attention_head_dim, upsample_type=us, attn_impl=attn_impl, **skip, **common)
    if t in ("SkipUpBlock2D", "AttnSkipUpBlock2D"):
        attn = dict(with_attention=True, attention_head_dim=attention_head_dim, attn_impl=attn_impl) \
            if t == "AttnSkipUpBlock2D" else {}
        return SkipUpBlock1D(*io, temb_channels, skip_channels=skip_channels, **skip,
                             resnet_time_scale_shift=resnet_time_scale_shift, add_upsample=add_upsample,
                             **attn, **common)
    if t in ("UpDecoderBlock2D", "AttnUpDecoderBlock2D"):
        attn = dict(with_attention=True, attention_head_dim=attention_head_dim, attn_impl=attn_impl) \
            if t == "AttnUpDecoderBlock2D" else {}
        return UpDecoderBlock1D(prev_output_channel, out_channels, temb_channels, resnet_groups=groups,
                                resnet_time_scale_shift=resnet_time_scale_shift, add_upsample=add_upsample,
                                **attn, **common)
    k = dict(prev_output_channel=prev_output_channel, add_upsample=add_upsample, **skip)
    if t == "KUpBlock2D":
        return KUpBlock1D(in_channels, out_channels, temb_channels, **k, **common)
    if t == "KCrossAttnUpBlock2D":
        return KCrossAttnUpBlock1D(
            in_channels, out_channels, temb_channels, cross_attention_dim=cross_attention_dim,
            attention_head_dim=attention_head_dim or 1, attn_impl=attn_impl, context_dim=context_dim, **k, **common)
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
    context_dim: Optional[int] = None,
) -> Optional[nn.Module]:
    """The JAX `get_mid_block` (None for no mid block); `context_dim` as in
    `get_down_block`."""
    if mid_block_type is None:
        return None
    t = _norm_type(mid_block_type)
    common = dict(resnet_eps=resnet_eps, resnet_act_fn=resnet_act_fn, resnet_groups=resnet_groups,
                  resnet_time_scale_shift=resnet_time_scale_shift, output_scale_factor=mid_block_scale_factor,
                  attn_impl=attn_impl)
    if t == "UNetMidBlock2D":
        return MidBlock1D(in_channels, temb_channels, attention_head_dim=attention_head_dim, **common)
    if t == "UNetMidBlock2DCrossAttn":
        return MidBlock1DCrossAttn(
            in_channels, temb_channels, transformer_layers_per_block=transformer_layers_per_block,
            num_attention_heads=num_attention_heads,
            cross_attention_dim=_kv_width(context_dim, cross_attention_dim, num_attention_heads, in_channels),
            dual_cross_attention=dual_cross_attention, only_cross_attention=only_cross_attention, **common)
    if t == "UNetMidBlock2DSimpleCrossAttn":
        return MidBlock1DSimpleCrossAttn(
            in_channels, temb_channels, attention_head_dim=attention_head_dim or 1,
            cross_attention_dim=cross_attention_dim, skip_time_act=resnet_skip_time_act,
            only_cross_attention=only_cross_attention, cross_attention_norm=cross_attention_norm,
            context_dim=context_dim, **common)
    raise ValueError(f"unknown mid_block_type : {mid_block_type}")
