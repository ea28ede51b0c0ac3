"""Diffusion schedules: discrete DDPM coefficients + continuous VP wrapper.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/schedule.py`.
`DiffusionSchedule` holds the discrete tables (f64 arithmetic, f32 storage).
`NoiseSchedule` is the continuous-time VP view the continuous samplers
use: piecewise-linear interpolation of 0.5*log(alpha_cumprod) over
t in [1/N, 1], and its inverse from half-logSNR to t.  Its tables and
outputs are f32 CPU tensors, as the JAX version's are f32 arrays; the
samplers read their per-step coefficients off them as Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["linear_beta_schedule", "DiffusionSchedule", "NoiseSchedule"]


def linear_beta_schedule(timesteps: int, max_beta: float = 0.02) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray = field(init=False)
    alphas_cumprod_prev: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(init=False)
    posterior_variance: np.ndarray = field(init=False)
    posterior_log_variance_clipped: np.ndarray = field(init=False)
    posterior_mean_coef1: np.ndarray = field(init=False)
    posterior_mean_coef2: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        pv = betas * (1.0 - ac_prev) / (1.0 - ac)

        def setf(name, val):
            object.__setattr__(self, name, np.asarray(val, np.float32))

        setf("betas", betas)
        setf("alphas_cumprod", ac)
        setf("alphas_cumprod_prev", ac_prev)
        setf("sqrt_alphas_cumprod", np.sqrt(ac))
        setf("sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - ac))
        setf("sqrt_recip_alphas_cumprod", np.sqrt(1.0 / ac))
        setf("sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / ac - 1.0))
        setf("posterior_variance", pv)
        setf("posterior_log_variance_clipped", np.log(np.maximum(pv, 1e-20)))
        setf("posterior_mean_coef1", betas * np.sqrt(ac_prev) / (1.0 - ac))
        setf("posterior_mean_coef2", (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))

    @classmethod
    def linear(cls, timesteps: int = 1000, max_beta: float = 0.02) -> "DiffusionSchedule":
        return cls(linear_beta_schedule(timesteps, max_beta))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """np.interp / jnp.interp in the tensors' dtype (xp increasing; x is
    clamped to [xp[0], xp[-1]])."""
    x = x.clamp(xp[0], xp[-1])
    i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    w = (x - x0) / (x1 - x0)
    return f0 + w * (f1 - f0)


class NoiseSchedule:
    """Continuous-time VP schedule over a discrete beta array."""

    def __init__(self, betas: np.ndarray):
        betas = np.asarray(betas, np.float64)
        self.total_N = len(betas)
        self.T = 1.0
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
        self.t_array = torch.tensor((np.arange(self.total_N) + 1.0) / self.total_N, dtype=torch.float32)
        self.log_alpha_array = torch.tensor(log_alphas, dtype=torch.float32)

    def marginal_log_mean_coeff(self, t):
        return _interp(torch.as_tensor(t, dtype=torch.float32), self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))
        return log_mean - log_std

    def to_model_t(self, t):
        """Continuous t in [1/N, 1] -> discrete model input in [0, N-1]."""
        return (t - 1.0 / self.total_N) * 1000.0

    def inverse_lambda(self, lamb):
        """Continuous t for a given half-logSNR: interpolation over the
        flipped log-alpha table (the singlestep and adaptive solvers' inner
        times)."""
        lamb = torch.as_tensor(lamb, dtype=torch.float32)
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
        return _interp(log_alpha, self.log_alpha_array.flip(0), self.t_array.flip(0))
