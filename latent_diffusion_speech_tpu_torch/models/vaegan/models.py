"""The HiFi-VAEGAN codec's VAE encoder and HiFi-GAN generator in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/models.py`:
* `VAEEncoder`: conv_pre k7 -> per stage [leaky_relu 0.1, strided conv over
  the reversed upsample rates and kernels with padding (k - u + 1) // 2,
  multi-receptive-field average of ResBlocks] -> leaky_relu 0.01 ->
  conv_post k7 -> split (m, logs), z = m + eps * exp(logs);
* `Generator` (the decoder): conv_pre k7 -> per stage [leaky_relu 0.1,
  transposed conv, multi-receptive-field average] -> leaky_relu 0.01 ->
  conv_post k7 -> tanh.
The JAX package computes these convolutions outside any Pallas kernel, so
here they are `F.conv1d` / `F.conv_transpose1d`.  Audio comes in as (B, T),
latents as (B, T, C), and the layers run channels-first.  Submodule names
follow the flax tree (`down_0`, `up_0`, `res_0_1.conv1_2`, ...), so
`convert.encoder_from_jax` / `generator_from_jax` map one onto the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig

__all__ = ["VAEEncoder", "Generator", "ResBlock1", "ResBlock2", "LRELU_SLOPE"]

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


def _add_mrf(module: nn.Module, cfg: VAEGANConfig, channels: int, stage: int) -> None:
    block = ResBlock1 if cfg.resblock == "1" else ResBlock2
    for j, (rk, d) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
        module.add_module(f"res_{stage}_{j}", block(channels, rk, tuple(d)))


def _mrf(module: nn.Module, x: torch.Tensor, stage: int) -> torch.Tensor:
    """Multi-receptive-field fusion: average of parallel resblocks."""
    n = len(module.cfg.resblock_kernel_sizes)
    acc = None
    for j in range(n):
        y = getattr(module, f"res_{stage}_{j}")(x)
        acc = y if acc is None else acc + y
    return acc / n


class VAEEncoder(nn.Module):
    """Audio (B, T) -> (z, m, logs), each (B, T // hop, inter_channels)."""

    def __init__(self, cfg: VAEGANConfig):
        super().__init__()
        self.cfg = cfg
        n_stages = len(cfg.upsample_rates)
        uic = cfg.upsample_initial_channel
        ch = uic // (2 ** n_stages)
        self.conv_pre = _conv(1, ch, 7)
        rates, kernels = reversed(cfg.upsample_rates), reversed(cfg.upsample_kernel_sizes)
        for i, (u, k) in enumerate(zip(rates, kernels)):
            out = uic // (2 ** (n_stages - i - 1))
            self.add_module(f"down_{i}", nn.Conv1d(ch, out, k, stride=u, padding=(k - u + 1) // 2))
            ch = out
            _add_mrf(self, cfg, ch, i)
        self.conv_post = _conv(ch, 2 * cfg.inter_channels, 7)

    def forward(self, audio: torch.Tensor, generator: Optional[torch.Generator] = None, sample: bool = True):
        """z = m + eps * exp(logs) with eps drawn from `generator` (None:
        torch's default generator of the audio's device) when `sample`, else
        z = m."""
        x = self.conv_pre(audio[:, None, :].to(self.conv_pre.weight.dtype))
        for i in range(len(self.cfg.upsample_rates)):
            x = getattr(self, f"down_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            x = _mrf(self, x, i)
        x = self.conv_post(F.leaky_relu(x))  # default slope 0.01, as the reference
        m, logs = x.transpose(1, 2).split(self.cfg.inter_channels, dim=-1)
        if not sample:
            return m, m, logs
        eps = torch.randn(m.shape, generator=generator, dtype=m.dtype, device=m.device)
        return m + eps * torch.exp(logs), m, logs


class Generator(nn.Module):
    """Latents (B, T, inter_channels) -> waveform (B, T * hop)."""

    def __init__(self, cfg: VAEGANConfig):
        super().__init__()
        self.cfg = cfg
        uic = cfg.upsample_initial_channel
        self.conv_pre = _conv(cfg.inter_channels, uic, 7)
        ch = uic
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            out = uic // (2 ** (i + 1))
            self.add_module(
                f"up_{i}", nn.ConvTranspose1d(ch, out, k, stride=u, padding=(k - u + 1) // 2)
            )
            ch = out
            _add_mrf(self, cfg, ch, i)
        self.conv_post = _conv(ch, 1, 7)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(z.transpose(1, 2).to(self.conv_pre.weight.dtype))
        for i in range(len(self.cfg.upsample_rates)):
            up = getattr(self, f"up_{i}")
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = _mrf(self, x, i)
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0, :]
