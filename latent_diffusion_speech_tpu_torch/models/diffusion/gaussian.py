"""Gaussian diffusion: the training loss and sampling.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/gaussian.py`:
spec normalisation by the scalar `acoustic_scale`, the frame axis padded to
the UNet's downsample grid and cropped back, the eps-prediction loss
`p_losses` (L2 or L1, t uniform in [0, k_step)), and `sample` from pure
noise (or a given `x_init`) with every sampler the JAX package names:
UniPC (the default), DPM-Solver++ (multistep, singlestep, adaptive),
UniPC vary-coeff, DDIM, PNDM and DDPM (also for `method=None` or
`infer_speedup <= 1`), or shallow diffusion from a ground-truth spec
(`k_step` with `gt_spec`: from q_sample(gt, k_step - 1) over k_step
timesteps).

Layout: condition (B, T, H), spec (B, T, M); the denoiser input is the
channel concat [x_t ++ cond] -> (B, T, M + H).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.diffusion import samplers
from latent_diffusion_speech_tpu_torch.models.diffusion.samplers import (
    ddim_sample,
    ddpm_sample,
    dpmpp_adaptive_sample,
    dpmpp_sample,
    dpmpp_singlestep_sample,
    plms_sample,
    unipc_sample,
    unipc_vary_sample,
)
from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import DiffusionSchedule, NoiseSchedule
from latent_diffusion_speech_tpu_torch.parallel import mesh as rows

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
        this `sample` call (None without the hook, and in `p_losses`).

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

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(alpha_bar_t) x_0 + sqrt(1 - alpha_bar_t) noise, t (B,)."""
        s = self.schedule
        a = torch.as_tensor(s.sqrt_alphas_cumprod, device=x_start.device)[t][:, None, None]
        b = torch.as_tensor(s.sqrt_one_minus_alphas_cumprod, device=x_start.device)[t][:, None, None]
        return a * x_start + b * noise

    def p_losses(
        self,
        gt_spec: torch.Tensor,
        cond: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        k_step: Optional[int] = None,
        loss_type: str = "l2",
    ) -> torch.Tensor:
        """Training loss, differentiable in the denoiser's parameters.
        gt_spec (B, T, M), cond (B, T, H); t and the noise are drawn from
        `generator` (on the tensors' device; a `parallel.mesh.RowGenerator`
        draws them for the global batch and keeps this rank's rows)."""
        if loss_type not in ("l1", "l2"):
            raise NotImplementedError(loss_type)
        B = gt_spec.shape[0]
        t_max = k_step or self.k_step
        t = rows.randint(0, t_max, (B,), generator, device=gt_spec.device)
        x_start = self.norm_spec(gt_spec)
        noise = rows.randn(x_start.shape, generator, device=x_start.device, dtype=x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)

        x_noisy, cond, orig_T = self._pad(x_noisy, cond)
        eps_hat = self.denoise_fn(None, torch.cat([x_noisy, cond.to(x_noisy.dtype)], dim=-1), t)[:, :orig_T]
        if loss_type == "l1":
            return (noise - eps_hat).abs().mean()
        return ((noise - eps_hat) ** 2).mean()

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
        method: str = "unipc",
        infer_speedup: int = 10,
        k_step: Optional[int] = None,
        gt_spec: Optional[torch.Tensor] = None,
        x_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate spec (B, T, M) from condition (B, T, H), starting from
        `x_init` if given, else from N(0, 1) noise drawn with `generator`
        (which also draws DDPM's per-step noise).  method: 'unipc',
        'dpm-solver', 'dpm-solver-singlestep', 'dpm-solver-adaptive',
        'unipc-vary', 'ddim', 'pndm' or 'ddpm'; None or infer_speedup <= 1
        runs DDPM over all k_step timesteps, as in the JAX package.

        Shallow diffusion (gt_spec (B, T, M) and k_step both given): the
        sampler runs over the first k_step timesteps, from
        q_sample(norm_spec(gt_spec), k_step - 1) with noise drawn from
        `generator` (ref diffusion.py:205-212); x_init still overrides the
        start."""
        B, T = cond.shape[:2]
        shallow = gt_spec is not None and k_step is not None
        t_max = k_step if shallow else self.k_step
        if x_init is not None:
            x = x_init.to(device=cond.device, dtype=cond.dtype)
        elif shallow:
            norm = self.norm_spec(gt_spec.to(cond.device))
            t0 = torch.full((B,), t_max - 1, dtype=torch.long, device=cond.device)
            x = self.q_sample(norm, t0, samplers._normal(norm, generator)).to(cond.dtype)
        else:
            x = torch.randn((B, T, self.out_dims), generator=generator, device=cond.device,
                            dtype=torch.float32).to(cond.dtype)
        x, cond_p, orig_T = self._pad(x, cond)
        params = self.prepare_sample_params() if self.prepare_sample_params is not None else None

        def eps_fn(x_t, t):
            return self.denoise_fn(params, torch.cat([x_t, cond_p.to(x_t.dtype)], dim=-1), t)

        if method is None or infer_speedup <= 1 or method == "ddpm":
            x = ddpm_sample(eps_fn, self.schedule, x, t_max, generator)
        elif method == "ddim":
            x = ddim_sample(eps_fn, self.schedule, x, t_max, infer_speedup)
        elif method == "pndm":
            x = plms_sample(eps_fn, self.schedule, x, t_max, infer_speedup)
        elif method == "dpm-solver":
            ns = NoiseSchedule(self.schedule.betas[:t_max])
            x = dpmpp_sample(eps_fn, ns, x, steps=t_max // infer_speedup, order=2)
        elif method == "unipc":
            ns = NoiseSchedule(self.schedule.betas[:t_max])
            x = unipc_sample(eps_fn, ns, x, steps=t_max // infer_speedup, order=2)
        elif method == "dpm-solver-singlestep":
            ns = NoiseSchedule(self.schedule.betas[:t_max])
            x = dpmpp_singlestep_sample(eps_fn, ns, x, steps=t_max // infer_speedup, order=2)
        elif method == "dpm-solver-adaptive":
            ns = NoiseSchedule(self.schedule.betas[:t_max])
            x = dpmpp_adaptive_sample(eps_fn, ns, x, order=2)
        elif method == "unipc-vary":
            ns = NoiseSchedule(self.schedule.betas[:t_max])
            x = unipc_vary_sample(eps_fn, ns, x, steps=t_max // infer_speedup, order=2)
        else:
            raise NotImplementedError(method)
        return self.denorm_spec(x[:, :orig_T])
