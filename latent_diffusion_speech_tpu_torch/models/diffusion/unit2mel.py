"""Unit2Mel: condition builder + UNet denoiser.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unit2mel.py`:

condition = unit_embed(units) [+ volume_embed(volume)] [+ spk_embed(spk_id-1)]
            [+ aug_shift_embed(aug_shift / 5)]

Only the flagship denoiser (`UNet1D`) is ported; `denoiser='general'` raises.
`Unit2MelSystem(unet_impl=...)` picks how the sampler runs the denoiser, as
in the JAX package: 'xla' (and 'auto') the eager module, 'pallas' the fused
whole-UNet kernel (`ops/kernels/unet_fused.py`) for B=1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from latent_diffusion_speech_tpu_torch.models.diffusion.gaussian import GaussianDiffusion
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.ops.kernels.unet_fused import pack_unet_params, unet_fwd
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, cast_compute_dtype, resolve_device, seeded

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
        device=None,
        seed: int = 0,
        unet_impl: str = "auto",
    ):
        """device: None means `cuda` (raises without a card).

        unet_impl: how sampling runs the denoiser, with the JAX package's
        values.  'xla' runs the eager `UNet1D` module (on the card, its
        self-attention is the K4 kernel).  'pallas' packs the weights once
        per `infer` call and sends every B=1 denoiser forward through the
        fused whole-UNet kernel (`ops/kernels/unet_fused.py::unet_fwd`: one
        launch per forward on the card, its plain version on the CPU); B>1
        stays on the eager module, as in the JAX package.  'auto' resolves
        to 'xla', as it does there."""
        if unet_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unet_impl must be 'auto', 'xla' or 'pallas', got {unet_impl!r}")
        if cfg.denoiser == "general" and unet_impl == "pallas":
            raise ValueError("the fused UNet kernel targets the flagship layout; use denoiser='flagship' with it")
        self.cfg = cfg
        self.unet_impl = unet_impl
        self.device = resolve_device(device)
        module = seeded(lambda: Unit2Mel(cfg), seed)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        self.module = cast_compute_dtype(module, dtype).to(self.device).eval()
        self.diffusion = GaussianDiffusion(
            denoise_fn=self._denoise,
            out_dims=cfg.out_dims,
            timesteps=cfg.timesteps,
            k_step=cfg.k_step,
            max_beta=cfg.max_beta,
            acoustic_scale=cfg.acoustic_scale,
            pad_multiple=2 ** (len(cfg.block_out_channels) - 1),
            prepare_sample_params=self._prepare_sample_params,
        )

    def _pallas_unet_active(self) -> bool:
        return self.unet_impl == "pallas"

    def _prepare_sample_params(self):
        """Once per `infer` call: the fused kernel's weight layout, or None."""
        if self._pallas_unet_active():
            return pack_unet_params(self.module.unet, self.cfg.unet_config())
        return None

    def _denoise(self, packed, x, t):
        if packed is not None and x.shape[0] == 1:
            return unet_fwd(packed, x, t, self.cfg.unet_config())
        return self.module.denoise(x, t)

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
