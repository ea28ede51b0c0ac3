"""Unit2Mel: condition builder + UNet denoiser.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unit2mel.py`:

condition = unit_embed(units) [+ volume_embed(volume)] [+ spk_embed(spk_id-1)]
            [+ aug_shift_embed(aug_shift / 5)]

Only the flagship denoiser (`UNet1D`) is ported; `denoiser='general'` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from latent_diffusion_speech_tpu_torch.models.diffusion.gaussian import GaussianDiffusion
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, cast_compute_dtype, seeded

__all__ = ["Unit2MelConfig", "Unit2Mel", "Unit2MelSystem"]


@dataclass(frozen=True)
class Unit2MelConfig:
    input_channel: int = 1280        # unit encoder dim (whisper_large_v3)
    n_spk: int = 323
    use_pitch_aug: bool = True
    out_dims: int = 128              # vocoder latent bins fed to diffusion
    n_layers: int = 2
    block_out_channels: Tuple[int, ...] = (256, 384, 512, 512)
    n_heads: int = 8
    n_hidden: int = 256
    acoustic_scale: float = 1.0
    is_tts: bool = True              # TTS mode: no volume conditioning
    timesteps: int = 1000
    k_step: int = 1000
    max_beta: float = 0.02
    conv_impl: str = "xla"           # kept for parity; one lowering per device
    attn_impl: str = "xla"           # kept for parity; CUDA always runs the K4 kernel
    gelu: str = "auto"               # GEGLU gelu: 'auto' (tanh iff B>=128) | 'exact' | 'tanh'
    qkv: str = "split"               # kept for parity; one lowering per device
    denoiser: str = "flagship"       # only 'flagship' is ported
    down_block_types: Optional[Tuple[str, ...]] = None
    up_block_types: Optional[Tuple[str, ...]] = None
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"

    def unet_config(self, remat: bool = False) -> UNet1DConfig:
        return UNet1DConfig(
            in_channels=self.out_dims + self.n_hidden,
            out_channels=self.out_dims,
            block_out_channels=self.block_out_channels,
            layers_per_block=self.n_layers,
            n_heads=self.n_heads,
            remat=remat,
            conv_impl=self.conv_impl,
            attn_impl=self.attn_impl,
            gelu=self.gelu,
            qkv=self.qkv,
        )


class Unit2Mel(nn.Module):
    def __init__(self, cfg: Unit2MelConfig):
        super().__init__()
        if cfg.denoiser != "flagship":
            raise NotImplementedError(
                f"denoiser {cfg.denoiser!r}: only 'flagship' is ported (ROADMAP.md)"
            )
        self.cfg = cfg
        self.unit_embed = Dense(cfg.input_channel, cfg.n_hidden)
        if not cfg.is_tts:
            self.volume_embed = Dense(1, cfg.n_hidden)
        if cfg.n_spk is not None and cfg.n_spk > 1:
            self.spk_embed = nn.Embedding(cfg.n_spk, cfg.n_hidden)
        if cfg.use_pitch_aug:
            self.aug_shift_embed = Dense(1, cfg.n_hidden, bias=False)
        self.unet = UNet1D(cfg.unet_config())

    def condition(self, units, volume=None, spk_id=None, aug_shift=None) -> torch.Tensor:
        """units (B, T, C_in) -> condition (B, T, n_hidden)."""
        cfg = self.cfg
        x = self.unit_embed(units)
        if volume is not None and not cfg.is_tts:
            x = x + self.volume_embed(volume[..., None])
        if cfg.n_spk is not None and cfg.n_spk > 1 and spk_id is not None:
            # reference convention: speaker ids are 1-based
            x = x + self.spk_embed(spk_id - 1)
        if cfg.use_pitch_aug and aug_shift is not None:
            x = x + self.aug_shift_embed(aug_shift[..., None] / 5.0)
        return x

    def denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t)


class Unit2MelSystem:
    """Owns the module on a device and the GaussianDiffusion around it."""

    def __init__(
        self,
        cfg: Unit2MelConfig,
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        device="cpu",
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        module = seeded(lambda: Unit2Mel(cfg), seed)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        self.module = cast_compute_dtype(module, dtype).to(self.device).eval()
        self.diffusion = GaussianDiffusion(
            denoise_fn=self.module.denoise,
            out_dims=cfg.out_dims,
            timesteps=cfg.timesteps,
            k_step=cfg.k_step,
            max_beta=cfg.max_beta,
            acoustic_scale=cfg.acoustic_scale,
            pad_multiple=2 ** (len(cfg.block_out_channels) - 1),
        )

    @torch.no_grad()
    def condition(self, units, volume=None, spk_id=None, aug_shift=None) -> torch.Tensor:
        return self.module.condition(units, volume, spk_id, aug_shift)

    @torch.no_grad()
    def infer(
        self,
        units,
        generator: Optional[torch.Generator] = None,
        volume=None,
        spk_id=None,
        aug_shift=None,
        method: str = "dpm-solver",
        infer_speedup: int = 10,
        x_init=None,
    ) -> torch.Tensor:
        cond = self.condition(units, volume, spk_id, aug_shift)
        return self.diffusion.sample(
            cond, generator, method=method, infer_speedup=infer_speedup, x_init=x_init
        )
