"""Gaussian diffusion sampling.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/gaussian.py`
(inference part): spec normalisation by the scalar `acoustic_scale`, the
frame axis padded to the UNet's downsample grid and cropped back, and
`sample` from pure noise (or a given `x_init`) with DPM-Solver++.  Training
losses, shallow diffusion from a ground-truth spec and the other samplers
are not ported yet (ROADMAP.md).

Layout: condition (B, T, H), spec (B, T, M); the denoiser input is the
channel concat [x_t ++ cond] -> (B, T, M + H).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.diffusion.samplers import dpmpp_sample
from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import DiffusionSchedule, NoiseSchedule

__all__ = ["GaussianDiffusion"]


class GaussianDiffusion:
    def __init__(
        self,
        denoise_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
        out_dims: int = 128,
        timesteps: int = 1000,
        k_step: int = 1000,
        max_beta: float = 0.02,
        acoustic_scale: float = 1.0,
        pad_multiple: int = 8,
        prepare_sample_params: Optional[Callable[[], Any]] = None,
    ):
        """denoise_fn: (params, [x_t ++ cond] (B, T, M+H), t (B,)) -> eps
        (B, T, M), where params is what `prepare_sample_params` returned for
        this `sample` call (None without the hook).

        prepare_sample_params: optional once-per-sample hook, run before the
        sampler loop (e.g. packing the weights into a kernel's layout), so
        its cost is paid once per call rather than per denoiser step."""
        self.denoise_fn = denoise_fn
        self.prepare_sample_params = prepare_sample_params
        self.out_dims = out_dims
        self.k_step = k_step
        self.acoustic_scale = acoustic_scale
        self.pad_multiple = pad_multiple
        self.schedule = DiffusionSchedule.linear(timesteps, max_beta)

    def norm_spec(self, x):
        return x * self.acoustic_scale

    def denorm_spec(self, x):
        return x / self.acoustic_scale

    def _pad(self, x, cond):
        """Pad the frame axis to the UNet downsample grid."""
        T = x.shape[1]
        pad = (self.pad_multiple - T % self.pad_multiple) % self.pad_multiple
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            cond = F.pad(cond, (0, 0, 0, pad))
        return x, cond, T

    @torch.no_grad()
    def sample(
        self,
        cond: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        method: str = "dpm-solver",
        infer_speedup: int = 10,
        x_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate spec (B, T, M) from condition (B, T, H), starting from
        `x_init` if given, else from N(0, 1) noise drawn with `generator`."""
        if method != "dpm-solver" or infer_speedup <= 1:
            raise NotImplementedError(
                f"sampler {method!r} (speedup {infer_speedup}) is not ported yet; "
                "only 'dpm-solver' with infer_speedup > 1 (see ROADMAP.md)"
            )
        B, T = cond.shape[:2]
        t_max = self.k_step
        if x_init is not None:
            x = x_init.to(device=cond.device, dtype=cond.dtype)
        else:
            x = torch.randn((B, T, self.out_dims), generator=generator, device=cond.device,
                            dtype=torch.float32).to(cond.dtype)
        x, cond_p, orig_T = self._pad(x, cond)
        params = self.prepare_sample_params() if self.prepare_sample_params is not None else None

        def eps_fn(x_t, t):
            return self.denoise_fn(params, torch.cat([x_t, cond_p.to(x_t.dtype)], dim=-1), t)

        ns = NoiseSchedule(self.schedule.betas[:t_max])
        x = dpmpp_sample(eps_fn, ns, x, steps=t_max // infer_speedup, order=2)
        return self.denorm_spec(x[:, :orig_T])
