"""The discriminator bank for codec (GAN) training.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/discriminators.py`:
multi-period (2-D convolutions over the (T / p, p) folded signal),
multi-scale (grouped wide-kernel 1-D convolutions) and EnCodec-style
complex-STFT (2-D convolutions over (time, frequency), the port's
`ops/stft.py` with center=False and a normalised window) discriminators.
The JAX package computes these convolutions outside any Pallas kernel, so
here they are cuDNN's.  The layers run channels-first, as the reference
bank does: feature maps are (B, C, T) or (B, C, H, W), where the flax bank's
are channels-last; the STFT discriminator's logits are (B, 1, T', F'), the
others' (B, N).  Submodules are named after the flax tree (`stft_0.Conv_3`,
`scale.Conv_0`, `period_2.Conv_5`), so `convert.discriminator_bank_from_jax`
maps one onto the other; `init_weights` draws flax's `nn.Conv` defaults
(LeCun-normal over in / groups x taps, zero biases).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.stft import hann_window, stft

__all__ = ["PeriodDiscriminator", "ScaleDiscriminator", "STFTDiscriminator", "DiscriminatorBank", "PERIODS"]

DISC_LRELU = 0.1
STFT_LRELU = 0.2

PERIODS = (2, 3, 5, 7, 11, 13, 19, 23, 29)


class PeriodDiscriminator(nn.Module):
    """Fold audio to (T / p, p) (reflect-padded to a multiple of p) and run
    2-D convolutions over the folded time axis."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        cin = 1
        for j, ch in enumerate((32, 128, 512, 1024)):
            self.add_module(f"Conv_{j}", nn.Conv2d(cin, ch, (kernel_size, 1), (stride, 1), padding=(pad, 0)))
            cin = ch
        self.Conv_4 = nn.Conv2d(1024, 1024, (kernel_size, 1), padding=(2, 0))
        self.Conv_5 = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
        h = x.reshape(B, 1, -1, p)
        fmap = []
        for j in range(5):
            h = F.leaky_relu(getattr(self, f"Conv_{j}")(h), DISC_LRELU)
            fmap.append(h)
        h = self.Conv_5(h)
        fmap.append(h)
        return h.reshape(B, -1), fmap


class ScaleDiscriminator(nn.Module):
    """Grouped wide-kernel 1-D convolutions over the raw signal."""

    LAYERS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20), (1024, 41, 4, 64, 20),
              (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))  # (out, kernel, stride, groups, padding)

    def __init__(self):
        super().__init__()
        cin = 1
        for j, (ch, k, s, g, p) in enumerate(self.LAYERS):
            self.add_module(f"Conv_{j}", nn.Conv1d(cin, ch, k, s, padding=p, groups=g))
            cin = ch
        self.Conv_6 = nn.Conv1d(1024, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B = x.shape[0]
        h = x[:, None]
        fmap = []
        for j in range(len(self.LAYERS)):
            h = F.leaky_relu(getattr(self, f"Conv_{j}")(h), DISC_LRELU)
            fmap.append(h)
        h = self.Conv_6(h)
        fmap.append(h)
        return h.reshape(B, -1), fmap


class STFTDiscriminator(nn.Module):
    """2-D convolutions over the normalised complex STFT (real and imaginary
    parts as two channels, time by frequency) at one scale."""

    def __init__(self, n_fft: int, hop_length: int, win_length: int, filters: int = 32,
                 dilations: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.n_dilated = len(dilations)
        self.Conv_0 = nn.Conv2d(2, filters, (3, 9), padding=(1, 4))
        for j, d in enumerate(dilations, start=1):
            self.add_module(f"Conv_{j}", nn.Conv2d(filters, filters, (3, 9), stride=(1, 2), dilation=(d, 1),
                                                   padding=(d, 4)))
        n = len(dilations) + 1
        self.add_module(f"Conv_{n}", nn.Conv2d(filters, filters, (3, 3), padding=(1, 1)))
        self.add_module(f"Conv_{n + 1}", nn.Conv2d(filters, 1, (3, 3), padding=(1, 1)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        window = hann_window(self.win_length, device=x.device)
        spec = stft(x, self.n_fft, self.hop_length, self.win_length, window, center=False)
        spec = spec / torch.sqrt((window**2).sum())  # normalized=True
        h = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)  # (B, 2, T, F)
        fmap = []
        n = self.n_dilated + 2
        for j in range(n):
            h = F.leaky_relu(getattr(self, f"Conv_{j}")(h), STFT_LRELU)
            fmap.append(h)
        return getattr(self, f"Conv_{n}")(h), fmap


class DiscriminatorBank(nn.Module):
    """The STFT discriminators (one a scale), the scale discriminator and
    one period discriminator a period: (logits, feature maps), in that
    order."""

    def __init__(
        self,
        periods: Sequence[int] = PERIODS,
        stft_scales: Sequence[Tuple[int, int, int]] = (
            (1024, 256, 1024),
            (2048, 512, 2048),
            (512, 128, 512),
            (256, 64, 256),
            (128, 32, 128),
        ),
    ):
        super().__init__()
        self.periods, self.stft_scales = tuple(periods), tuple(stft_scales)
        for i, (n_fft, hop, win) in enumerate(self.stft_scales):
            self.add_module(f"stft_{i}", STFTDiscriminator(n_fft, hop, win))
        self.scale = ScaleDiscriminator()
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p))

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        names = [f"stft_{i}" for i in range(len(self.stft_scales))] + ["scale"] + [f"period_{p}" for p in self.periods]
        for name in names:
            lg, fm = getattr(self, name)(x)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps
