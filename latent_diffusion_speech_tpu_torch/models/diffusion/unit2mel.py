"""Unit2Mel: condition builder + UNet denoiser.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/unit2mel.py`:

condition = unit_embed(units) [+ volume_embed(volume)] [+ spk_embed(spk_id-1)]
            [+ aug_shift_embed(aug_shift / 5)]

`denoiser` picks the backbone as in the JAX package: 'flagship' is the
perf-tuned `UNet1D`; 'general' is `UNet1DCondition`, the reference's own
block layout, built from `Unit2MelConfig.general_unet_config()` with any of
the block zoo's types as overrides (`down_block_types`, `up_block_types`,
`mid_block_type`; their attention blocks run heads of dim `n_heads`).
`attn_impl` picks the UNet's attention: 'pallas' is the K5 kernel (f32
probabilities, no backward, so `loss` raises with it); 'xla' and 'fused'
are K4 in the flagship, and the plain path ('xla') or K4 ('fused', T <=
512) in the general denoiser (K4's backward takes no head dim 8, so the
block zoo's attention blocks train with 'xla').
`Unit2MelSystem(unet_impl=...)` picks how the sampler runs the flagship
denoiser: 'xla' (and 'auto') the eager module, 'pallas' the fused
whole-UNet kernel (`ops/kernels/unet_fused.py`) for B=1.  `Unit2MelSystem.loss`
is the training loss; the diffusion trainer (`train/diffusion_trainer.py`)
trains `Unit2MelSystem.module` in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from latent_diffusion_speech_tpu_torch.models.diffusion.gaussian import GaussianDiffusion
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d_condition import (
    UNet1DCondition,
    UNet1DConditionConfig,
)
from latent_diffusion_speech_tpu_torch.ops.kernels.unet_fused import pack_unet_params, unet_fwd
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, cast_compute_dtype, resolve_device, seeded
from latent_diffusion_speech_tpu_torch.ops.weight_quant import dequantize_tree, quantize_tree_int8
from latent_diffusion_speech_tpu_torch.utils import profiler

__all__ = ["Unit2MelConfig", "Unit2Mel", "Unit2MelSystem"]


class _Int8Unet(NamedTuple):
    """The UNet's parameters as `quantize_tree_int8` leaves, for one serve call."""

    qparams: dict


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
    attn_impl: str = "xla"           # UNet attention: 'xla' | 'fused' (K4) | 'pallas' (K5)
    gelu: str = "auto"               # GEGLU gelu: 'auto' (tanh iff B>=128) | 'exact' | 'tanh'
    qkv: str = "split"               # kept for parity; one lowering per device
    # Denoiser backbone: 'flagship' = the perf-tuned effective architecture
    # (UNet1D); 'general' = the reference-layout block-graph UNet
    # (UNet1DCondition), with the block-type overrides below (None = the
    # reference's effective types).
    denoiser: str = "flagship"
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

    def general_unet_config(self) -> UNet1DConditionConfig:
        """UNet1DConditionConfig equivalent of the effective architecture,
        with any block-type overrides applied (Unit2Mel pins
        only_cross_attention=True + scale_shift)."""
        n = len(self.block_out_channels)
        down = self.down_block_types or (("CrossAttnDownBlock2D",) * (n - 1) + ("DownBlock2D",))
        up = self.up_block_types or (("UpBlock2D",) + ("CrossAttnUpBlock2D",) * (n - 1))
        return UNet1DConditionConfig(
            in_channels=self.out_dims + self.n_hidden,
            out_channels=self.out_dims,
            block_out_channels=self.block_out_channels,
            down_block_types=tuple(down),
            up_block_types=tuple(up),
            mid_block_type=self.mid_block_type,
            layers_per_block=self.n_layers,
            norm_num_groups=8,
            cross_attention_dim=tuple(self.block_out_channels),
            attention_head_dim=self.n_heads,
            only_cross_attention=True,
            resnet_time_scale_shift="scale_shift",
        )


class Unit2Mel(nn.Module):
    def __init__(self, cfg: Unit2MelConfig, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.unit_embed = Dense(cfg.input_channel, cfg.n_hidden)
        if not cfg.is_tts:
            self.volume_embed = Dense(1, cfg.n_hidden)
        if cfg.n_spk is not None and cfg.n_spk > 1:
            self.spk_embed = nn.Embedding(cfg.n_spk, cfg.n_hidden)
        if cfg.use_pitch_aug:
            self.aug_shift_embed = Dense(1, cfg.n_hidden, bias=False)
        if cfg.denoiser == "general":
            self.unet = UNet1DCondition(cfg.general_unet_config(), attn_impl=cfg.attn_impl)
        else:
            self.unet = UNet1D(cfg.unet_config(remat))

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
        remat: bool = False,
        weight_quant: Optional[str] = None,
    ):
        """device: None means `cuda` (raises without a card).  remat:
        recompute the flagship UNet's blocks in the backward (as the JAX
        package's `remat`; the general denoiser has none there either).

        unet_impl: how sampling runs the denoiser, with the JAX package's
        values.  'xla' runs the eager module (on the card its attention is
        the kernel `attn_impl` names: K4, or K5 for 'pallas').  'pallas' packs the weights once
        per `infer` call and sends every B=1 denoiser forward through the
        fused whole-UNet kernel (`ops/kernels/unet_fused.py::unet_fwd`: one
        launch per forward on the card, its plain version on the CPU); B>1
        stays on the eager module, as in the JAX package.  'auto' resolves
        to 'xla', as it does there.  'pallas' targets the flagship layout and
        raises with denoiser='general'.

        weight_quant: 'int8' quantizes the UNet's weights once per `infer`
        call (`ops/weight_quant.py`: int8 values, a bf16 scale per output
        channel) and runs every denoiser forward on them dequantized to the
        compute dtype, as the JAX package does; the eager path only, with
        the JAX package's checks (not with unet_impl='pallas', not with the
        general denoiser).  Training and `loss` see the weights as they are."""
        if unet_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unet_impl must be 'auto', 'xla' or 'pallas', got {unet_impl!r}")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got {weight_quant!r}")
        if weight_quant is not None and unet_impl == "pallas":
            raise ValueError("weight_quant applies to the eager sampling path; not combinable with unet_impl='pallas'")
        if cfg.denoiser == "general" and (unet_impl == "pallas" or weight_quant is not None):
            raise ValueError("the fused UNet kernel and int8 weight packing target the flagship layout; use "
                             "denoiser='flagship' with them")
        self.cfg = cfg
        self.unet_impl = unet_impl
        self.weight_quant = weight_quant
        self.dtype = dtype
        self.device = resolve_device(device)
        module = seeded(lambda: Unit2Mel(cfg, remat), seed)
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
        """Once per `infer` call: the fused kernel's weight layout, the
        UNet's int8 weights, or None."""
        with profiler.span("diffusion.prepare"):
            if self._pallas_unet_active():
                return pack_unet_params(self.module.unet, self.cfg.unet_config())
            if self.weight_quant == "int8":
                return _Int8Unet(quantize_tree_int8(dict(self.module.unet.named_parameters())))
            return None

    def _denoise(self, packed, x, t):
        with profiler.span("denoiser.eval"):
            if isinstance(packed, _Int8Unet):
                weights = dequantize_tree(packed.qparams, dtype=self.dtype)
                return functional_call(self.module.unet, weights, (x, t))
            if packed is not None and x.shape[0] == 1:
                return unet_fwd(packed, x, t, self.cfg.unet_config())
            return self.module.denoise(x, t)

    @torch.no_grad()
    def condition(self, units, volume=None, spk_id=None, aug_shift=None) -> torch.Tensor:
        with profiler.span("diffusion.condition"):
            return self.module.condition(units, volume, spk_id, aug_shift)

    def loss(self, units, gt_spec, generator=None, volume=None, spk_id=None, aug_shift=None,
             k_step=None) -> torch.Tensor:
        """Training loss, differentiable in `self.module`'s parameters: the
        condition, then `GaussianDiffusion.p_losses` (t and noise drawn from
        `generator`)."""
        cond = self.module.condition(units, volume, spk_id, aug_shift)
        return self.diffusion.p_losses(gt_spec, cond, generator, k_step=k_step)

    @torch.no_grad()
    def infer(
        self,
        units,
        generator: Optional[torch.Generator] = None,
        volume=None,
        spk_id=None,
        aug_shift=None,
        method: str = "unipc",
        infer_speedup: int = 10,
        gt_spec=None,
        k_step=None,
        x_init=None,
    ) -> torch.Tensor:
        cond = self.condition(units, volume, spk_id, aug_shift)
        return self.diffusion.sample(
            cond, generator, method=method, infer_speedup=infer_speedup, k_step=k_step, gt_spec=gt_spec,
            x_init=x_init,
        )
