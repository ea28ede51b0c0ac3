"""HiFi-GAN generator of the HiFi-VAEGAN codec in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/models.py::Generator`
(the decoder; the VAE encoder is not ported yet): conv_pre k7 -> per stage
[leaky_relu 0.1, transposed conv, multi-receptive-field average of
ResBlocks] -> leaky_relu 0.01 -> conv_post k7 -> tanh.  The JAX package
computes these convolutions outside any Pallas kernel, so here they are
`F.conv1d` / `F.conv_transpose1d`.  Latents come in as (B, T, C) and the
layers run channels-first.  Submodule names follow the flax tree
(`up_0`, `res_0_1.conv1_2`, ...), so `convert.generator_from_jax` maps one
onto the other.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig

__all__ = ["Generator", "ResBlock1", "ResBlock2", "LRELU_SLOPE"]

LRELU_SLOPE = 0.1


def _same_pad(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding=_same_pad(k, dilation))


class ResBlock1(nn.Module):
    """3x (dilated conv + plain conv) residual stack."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", _conv(channels, channels, kernel_size, d))
            self.add_module(f"conv2_{i}", _conv(channels, channels, kernel_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            c1, c2 = getattr(self, f"conv1_{i}"), getattr(self, f"conv2_{i}")
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = x + xt
        return x


class ResBlock2(nn.Module):
    """2x dilated conv residual stack."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv_{i}", _conv(channels, channels, kernel_size, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = x + getattr(self, f"conv_{i}")(F.leaky_relu(x, LRELU_SLOPE))
        return x


def _mrf(gen: "Generator", x: torch.Tensor, stage: int) -> torch.Tensor:
    """Multi-receptive-field fusion: average of parallel resblocks."""
    n = len(gen.cfg.resblock_kernel_sizes)
    acc = None
    for j in range(n):
        y = getattr(gen, f"res_{stage}_{j}")(x)
        acc = y if acc is None else acc + y
    return acc / n


class Generator(nn.Module):
    """Latents (B, T, inter_channels) -> waveform (B, T * hop)."""

    def __init__(self, cfg: VAEGANConfig):
        super().__init__()
        self.cfg = cfg
        uic = cfg.upsample_initial_channel
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.conv_pre = _conv(cfg.inter_channels, uic, 7)
        ch = uic
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            out = uic // (2 ** (i + 1))
            self.add_module(
                f"up_{i}", nn.ConvTranspose1d(ch, out, k, stride=u, padding=(k - u + 1) // 2)
            )
            ch = out
            for j, (rk, d) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", block(ch, rk, tuple(d)))
        self.conv_post = _conv(ch, 1, 7)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(z.transpose(1, 2).to(self.conv_pre.weight.dtype))
        for i in range(len(self.cfg.upsample_rates)):
            up = getattr(self, f"up_{i}")
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = _mrf(self, x, i)
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0, :]
