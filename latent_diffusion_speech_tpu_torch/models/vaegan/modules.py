"""WaveNet (WN) + ConvReluNorm + flow modules from the codec's module bag.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/modules.py` (the
reference's `encoder/hifi_vaegan/modules/modules.py`, VITS lineage; no
forward path of the reference or of either package uses them).  The
interface is the JAX modules': channels-last (B, T, C) tensors and
(B, T, 1) masks.  Submodule names follow the flax tree (`in_layers_0`,
`res_skip_layers_0`, `conv_layers_0`, `norm_layers_0`, `proj`), so
`convert.vaegan_modules_from_jax` maps one onto the other, and the two
importers read the reference's weight-normed torch state dicts into that
tree, as JAX's do.  Dropout draws from a `torch.Generator` passed in (off
without one), the counterpart of the JAX modules' `dropout_rng`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.attention import dropout
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, LayerNorm

__all__ = [
    "DilatedConv1d",
    "WN1D",
    "ConvReluNorm1D",
    "log_flow",
    "flip_flow",
    "wn_params_from_torch",
    "conv_relu_norm_params_from_torch",
]


class DilatedConv1d(nn.Conv1d):
    """'Same'-padded dilated convolution over (B, T, C): padding
    (k d - d) // 2 on both sides, as the reference's `nn.Conv1d(..., dilation)`."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, dilation: int = 1):
        pad = (kernel_size * dilation - dilation) // 2
        super().__init__(in_channels, features, kernel_size, dilation=dilation, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2).to(self.weight.dtype)).transpose(1, 2)


class WN1D(nn.Module):
    """WaveNet stack: n_layers of [dilated conv to 2H, gated tanh * sigmoid,
    1x1 res + skip], accumulating the skip stream (the reference's `WN`
    without its `g` conditioning)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int, n_layers: int):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        for i in range(n_layers):
            self.add_module(f"in_layers_{i}", DilatedConv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i))
            self.add_module(f"res_skip_layers_{i}", Dense(h, 2 * h if i < n_layers - 1 else h))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0) -> torch.Tensor:
        h = self.hidden_channels
        mask = torch.ones_like(x[..., :1]) if x_mask is None else x_mask
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_layers_{i}")(x)
            acts = dropout(torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:]), dropout_rate, generator)
            res_skip = getattr(self, f"res_skip_layers_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * mask


class ConvReluNorm1D(nn.Module):
    """Conv -> LayerNorm -> ReLU stack with a zero-initialised residual
    projection (the reference's `ConvReluNorm`; its channels-first
    LayerNorm is a last-axis LayerNorm here).  The residual needs
    out_channels == in_channels, as in the JAX module."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, kernel_size: int,
                 n_layers: int):
        super().__init__()
        assert n_layers > 1, "Number of layers should be larger than 0."
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_layers_{i}",
                            DilatedConv1d(in_channels if i == 0 else hidden_channels, hidden_channels, kernel_size))
            self.add_module(f"norm_layers_{i}", LayerNorm(hidden_channels, 1e-5))
        self.proj = Dense(hidden_channels, out_channels)
        with torch.no_grad():
            self.proj.weight.zero_()
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0) -> torch.Tensor:
        mask = torch.ones_like(x[..., :1]) if x_mask is None else x_mask
        x_org = x
        for i in range(self.n_layers):
            conv = getattr(self, f"conv_layers_{i}")
            x = getattr(self, f"norm_layers_{i}")(conv(x * mask)).to(conv.weight.dtype)
            x = dropout(F.relu(x), dropout_rate, generator)
        return (x_org + self.proj(x)) * mask


def log_flow(x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
    """`Log` flow: y = log(clamp(x, 1e-5)) with its log-determinant."""
    if not reverse:
        y = torch.log(x.clamp_min(1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))
    return torch.exp(x) * x_mask


def flip_flow(x: torch.Tensor, reverse: bool = False):
    """`Flip` flow: the channel axis reversed (axis -1, channels-last)."""
    x = torch.flip(x, dims=(-1,))
    if not reverse:
        return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return x


# -- importers ---------------------------------------------------------------


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach") else t, np.float32)


def wn_params_from_torch(state: Dict) -> Dict:
    """The reference's `WN` state dict (weight-normed convolutions) -> the
    flax WN1D tree (numpy), the weight norm folded."""
    from latent_diffusion_speech_tpu_torch.models.vaegan.import_torch import fold_weight_norm

    state = fold_weight_norm({k: _np(v) for k, v in state.items()})
    params: Dict = {}
    i = 0
    while f"in_layers.{i}.weight" in state:
        w = state[f"in_layers.{i}.weight"]  # (O, I, k)
        params[f"in_layers_{i}"] = {"kernel": np.transpose(w, (2, 1, 0)), "bias": state[f"in_layers.{i}.bias"]}
        rs = state[f"res_skip_layers.{i}.weight"]  # (O, I, 1)
        params[f"res_skip_layers_{i}"] = {"kernel": rs[:, :, 0].T, "bias": state[f"res_skip_layers.{i}.bias"]}
        i += 1
    return params


def conv_relu_norm_params_from_torch(state: Dict) -> Dict:
    """The reference's `ConvReluNorm` state dict -> the flax ConvReluNorm1D
    tree (numpy)."""
    state = {k: _np(v) for k, v in state.items()}
    params: Dict = {}
    i = 0
    while f"conv_layers.{i}.weight" in state:
        params[f"conv_layers_{i}"] = {
            "kernel": np.transpose(state[f"conv_layers.{i}.weight"], (2, 1, 0)),
            "bias": state[f"conv_layers.{i}.bias"],
        }
        params[f"norm_layers_{i}"] = {"scale": state[f"norm_layers.{i}.gamma"], "bias": state[f"norm_layers.{i}.beta"]}
        i += 1
    params["proj"] = {"kernel": state["proj.weight"][:, :, 0].T, "bias": state["proj.bias"]}
    return params
