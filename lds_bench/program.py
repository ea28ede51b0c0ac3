"""The system under test: `latent_diffusion_speech_tpu_torch`'s serving
pipeline (`TTSPipeline`) from units to waveform, built from the weights the
benchmark drew.  This is the one module of the benchmark that imports the
program, and it imports it only when `build` runs."""

from __future__ import annotations

import time
from typing import Dict

import torch

from lds_bench.trace import no_span


def unit2mel_config(cfg: dict):
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig

    return Unit2MelConfig(
        input_channel=cfg["input_channel"], n_spk=cfg["n_spk"], use_pitch_aug=cfg["use_pitch_aug"],
        out_dims=cfg["out_dims"], n_layers=cfg["n_layers"], block_out_channels=tuple(cfg["block_out_channels"]),
        n_heads=cfg["n_heads"], n_hidden=cfg["n_hidden"], acoustic_scale=cfg["acoustic_scale"], is_tts=True,
        timesteps=cfg["timesteps"], k_step=cfg["k_step_max"], max_beta=cfg["beta_end"],
        denoiser=cfg["program"]["denoiser"], attn_impl=cfg["program"]["attn_impl"],
    )


def vaegan_config(vcfg: dict):
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig

    return VAEGANConfig(
        sampling_rate=vcfg["sampling_rate"], inter_channels=vcfg["inter_channels"], resblock=vcfg["resblock"],
        resblock_kernel_sizes=tuple(vcfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in vcfg["resblock_dilation_sizes"]),
        upsample_rates=tuple(vcfg["upsample_rates"]), upsample_initial_channel=vcfg["upsample_initial_channel"],
        upsample_kernel_sizes=tuple(vcfg["upsample_kernel_sizes"]),
    )


def load_kernels() -> dict:
    """Loads the program's CUDA kernel library, which nvcc builds where the
    build directory has none for its sources yet: {"build_s": seconds,
    "built": whether nvcc ran}."""
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import build_info, load_library

    t0 = time.perf_counter()
    load_library()
    return {"build_s": time.perf_counter() - t0, "built": bool(build_info()["built"])}


def build(cfg: dict, u2m_weights: Dict[str, torch.Tensor], voc_weights: Dict[str, torch.Tensor], device):
    """The pipeline of configuration `cfg` on `device`, serving in
    `cfg["dtype"]` with the denoiser, attention and UNet paths that
    `cfg["program"]` names."""
    from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

    dtype = getattr(torch, cfg["dtype"])
    diffusion = Unit2MelSystem(unit2mel_config(cfg), state_dict=u2m_weights, dtype=dtype, device=device,
                               unet_impl=cfg["program"]["unet_impl"])
    vocoder = Vocoder("hifi-vaegan", vaegan_config(cfg["vocoder"]), state_dict=voc_weights, dtype=dtype,
                      device=device)
    return TTSPipeline(diffusion, vocoder, device=device)


def serve(pipe, request, sampler: dict, span=no_span):
    """One call as a serving caller makes it: units to waveform, copied to
    host memory.  Returns the waveform (B, frames * hop) as float32 numpy."""
    wav = pipe.infer(request.units, spk_id=request.spk, method=sampler["method"],
                     infer_speedup=sampler["infer_speedup"], x_init=request.x_init)
    with span("lds.host_copy"):
        return wav.float().cpu().numpy()
