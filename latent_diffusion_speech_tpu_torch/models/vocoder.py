"""Vocoder facade (counterpart of `latent_diffusion_speech_tpu/models/vocoder.py`).

Only the decode side of `hifi-vaegan` is ported: `infer(latents)` runs the
HiFi-GAN generator.  Latent extraction from audio (the VAE encoder) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, resolve_device, seeded

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
    ):
        """state_dict: the generator's weights (`convert.generator_from_jax`);
        None builds seeded random weights.  device: None means `cuda`
        (raises without a card)."""
        if vocoder_type != "hifi-vaegan":
            raise ValueError(f"[x] Unknown vocoder: {vocoder_type}")
        self.vocoder_type = vocoder_type
        self.cfg = cfg if cfg is not None else VAEGANConfig()
        self.device = resolve_device(device)
        gen = seeded(lambda: Generator(self.cfg), seed)
        if state_dict is not None:
            gen.load_state_dict(state_dict)
        self.generator = cast_compute_dtype(gen, dtype).to(self.device).eval()

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

    @torch.no_grad()
    def infer(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T, C) sampled latents -> (B, T*hop) waveform."""
        return self.generator(latents)

    decode = infer
