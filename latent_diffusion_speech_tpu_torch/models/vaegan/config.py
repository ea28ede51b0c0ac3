"""HiFi-VAEGAN hyperparameters (counterpart of
`latent_diffusion_speech_tpu/models/vaegan/config.py`): the 44.1 kHz /
hop-512 geometry, HiFi-GAN V1-style stacks with prod(upsample_rates) == 512."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["VAEGANConfig"]


@dataclass(frozen=True)
class VAEGANConfig:
    sampling_rate: int = 44100
    inter_channels: int = 128          # latent channels (the diffusion "mel" dims)
    resblock: str = "1"                # "1": 3-conv dilated | "2": 2-conv
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2, 2)        # prod == 512 == hop
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4, 4)

    @property
    def hop_size(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    @classmethod
    def from_torch_h(cls, h: dict) -> "VAEGANConfig":
        """Build from the reference's `h` config dict (decoder.pth['config'])."""
        return cls(
            sampling_rate=int(h["sampling_rate"]),
            inter_channels=int(h["inter_channels"]),
            resblock=str(h["resblock"]),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_initial_channel=int(h["upsample_initial_channel"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        )
