"""Vocoder facade (counterpart of `latent_diffusion_speech_tpu/models/vocoder.py`,
the reference's `diffusion/vocoder.py:5-33`).

`hifi-vaegan` is the one type: `extract(audio, sample_rate)` resamples to
the codec's rate when it differs and returns the (B, T_frames, 2C) latent
stats; `infer(latents)` decodes.  The checkpoint rule is the JAX
registry's: a `ckpt` directory loads the reference's `encoder.pth` +
`decoder.pth`; anything else builds seeded weights.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.ops.resample import resample
from latent_diffusion_speech_tpu_torch.utils import profiler

__all__ = ["Vocoder"]


class Vocoder:
    def __init__(
        self,
        vocoder_type: str = "hifi-vaegan",
        cfg: Optional[VAEGANConfig] = None,
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
        ckpt: Optional[str] = None,
    ):
        """ckpt: a directory with the reference's `encoder.pth` and
        `decoder.pth` (the geometry is theirs; `cfg` and `state_dict` are
        then not used).  Otherwise `cfg` (default: the 44.1 kHz codec) with
        `state_dict`, the generator's weights (`convert.generator_from_jax`),
        or seeded ones where it is None.  device: None means `cuda` (raises
        without a card)."""
        if vocoder_type != "hifi-vaegan":
            raise ValueError(f"[x] Unknown vocoder: {vocoder_type}")
        self.vocoder_type = vocoder_type
        if ckpt and os.path.isdir(ckpt):
            self.vocoder = HifiVAEGAN.from_torch_checkpoint(ckpt, dtype=dtype, device=device)
        else:
            self.vocoder = HifiVAEGAN(cfg if cfg is not None else VAEGANConfig(), generator_state=state_dict,
                                      dtype=dtype, device=device, seed=seed)
        self.cfg = self.vocoder.cfg
        self.device = self.vocoder.device
        self.generator = self.vocoder.generator

    @property
    def dimension(self) -> int:
        """Latent bins exposed to the diffusion model: 2*C (m ++ logs)."""
        return 2 * self.cfg.inter_channels

    @property
    def vocoder_sample_rate(self) -> int:
        return self.cfg.sampling_rate

    @property
    def vocoder_hop_size(self) -> int:
        return self.cfg.hop_size

    def extract(self, audio: torch.Tensor, sample_rate: int, **kw) -> torch.Tensor:
        """Audio (B, T) at any rate -> (B, T_frames, 2*C) latent stats."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if sample_rate != self.vocoder_sample_rate:
            audio = resample(audio, sample_rate, self.vocoder_sample_rate)
        return self.vocoder.extract(audio, **kw)

    @torch.no_grad()
    def infer(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T, C) sampled latents -> (B, T*hop) waveform."""
        with profiler.span("vocoder.infer"):
            return self.generator(latents)

    decode = infer
