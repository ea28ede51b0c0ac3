"""HiFi-VAEGAN codec facade: extract latents, decode waveforms, log-mel.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/codec.py` (the
reference wrapper `hifi_vaegan.py:10-70`):
* `extract(audio)` pads the audio on the right to a hop multiple, encodes,
  and returns concat([m, logs]) as (B, T // hop, 2C); `only_mean` zeroes
  logs, `only_z` returns the sample z = m + eps * exp(logs) (B, T // hop, C);
* `decode(z)` runs the generator on (B, T, C) latents -> (B, T * hop);
* `get_mel(audio)` is the 128-bin 44.1 kHz log-mel (2048 / 2048 / 512,
  40-16000 Hz), (B, T_frames, 128).

Seeded weights draw the codec's N(0, 0.01) convolutions with zero biases
(`ops/layers.py::init_weights`); `from_torch_checkpoint` reads the
reference's `encoder.pth` / `decoder.pth` pair.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder
from latent_diffusion_speech_tpu_torch.ops.layers import built_for_init, cast_compute_dtype, init_weights, resolve_device
from latent_diffusion_speech_tpu_torch.ops.stft import MelSpectrogram

__all__ = ["HifiVAEGAN"]

CONV_STD = 0.01  # the reference's init_weights (HiFi-GAN's), as the flax modules draw


class HifiVAEGAN:
    def __init__(
        self,
        cfg: VAEGANConfig,
        encoder_state: Optional[dict] = None,
        generator_state: Optional[dict] = None,
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        """encoder_state / generator_state: the port's state dicts
        (`convert.*_from_jax`, `import_torch.*_state_from_torch`); a missing
        one is seeded (the generator first, then the encoder, from one CPU
        generator seeded with `seed`).  device: None means `cuda` (raises
        without a card)."""
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        with built_for_init():
            generator, encoder = Generator(cfg), VAEEncoder(cfg)
        draws = torch.Generator().manual_seed(seed)
        for module, state in ((generator, generator_state), (encoder, encoder_state)):
            init_weights(module, draws, conv_std=CONV_STD)
            if state is not None:
                module.load_state_dict(state)
        self.generator = cast_compute_dtype(generator, dtype).to(self.device).eval()
        self.encoder = cast_compute_dtype(encoder, dtype).to(self.device).eval()
        self.mel = MelSpectrogram(sr=cfg.sampling_rate, n_mels=128, n_fft=2048, win_size=2048,
                                  hop_length=512, fmin=40, fmax=16000)

    # -- construction -------------------------------------------------------

    @classmethod
    def random_init(cls, cfg: Optional[VAEGANConfig] = None, seed: int = 0, dtype=torch.float32, device=None):
        return cls(cfg or VAEGANConfig(), dtype=dtype, device=device, seed=seed)

    @classmethod
    def from_torch_checkpoint(cls, model_path: str | Path, dtype=torch.float32, device=None):
        """Load the reference's `encoder.pth` / `decoder.pth` pair; the
        geometry comes from `decoder.pth["config"]`."""
        from latent_diffusion_speech_tpu_torch.models.vaegan.import_torch import (
            encoder_state_from_torch,
            generator_state_from_torch,
        )

        model_path = Path(model_path)
        dec = torch.load(model_path / "decoder.pth", map_location="cpu", weights_only=False)
        enc = torch.load(model_path / "encoder.pth", map_location="cpu", weights_only=False)
        cfg = VAEGANConfig.from_torch_h(dec["config"])
        return cls(cfg, encoder_state=encoder_state_from_torch(enc["model"], cfg),
                   generator_state=generator_state_from_torch(dec["model"], cfg), dtype=dtype, device=device)

    # -- properties mirroring the reference facade --------------------------

    @property
    def sample_rate(self) -> int:
        return self.cfg.sampling_rate

    @property
    def hop_size(self) -> int:
        return self.cfg.hop_size

    @property
    def dimension(self) -> int:
        return self.cfg.inter_channels

    # -- the codec ----------------------------------------------------------

    @torch.no_grad()
    def extract(
        self,
        audio: torch.Tensor,
        only_mean: bool = False,
        only_z: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Audio (B, T) -> latents (B, T // hop, 2C) [or (B, T // hop, C)
        with only_z, eps drawn from `generator`: None means a generator of
        the codec's device seeded with 0, as JAX's default key]."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if audio.dim() == 1:
            audio = audio[None]
        hop = self.hop_size
        if audio.shape[-1] % hop != 0:
            audio = F.pad(audio, (0, hop - audio.shape[-1] % hop))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        z, m, logs = self.encoder(audio, generator=generator, sample=only_z)
        if only_z:
            return z
        if only_mean:
            logs = torch.zeros_like(logs)
        return torch.cat([m, logs], dim=-1)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, T, C) -> waveform (B, T * hop)."""
        return self.generator(z)

    # reference name: forward == decode
    __call__ = decode

    def get_mel(self, audio: torch.Tensor, keyshift: float = 0.0) -> torch.Tensor:
        """(B, T) -> (B, T_frames, 128) log-mel (ref hifi_vaegan.py:67-70)."""
        return self.mel(torch.as_tensor(audio, device=self.device), keyshift=keyshift).transpose(-1, -2)
