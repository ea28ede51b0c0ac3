"""DPM-Solver++ (multistep, orders 1-2) as a Python loop.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/samplers.py::dpmpp_sample`
(time-uniform steps; the order builds up over the first steps and is lowered
at the last steps only when steps < 10).  The other samplers of the JAX
package (DDPM, DDIM, PLMS, UniPC, singlestep/adaptive DPM-Solver) are not
ported yet; see ROADMAP.md.

`eps_fn(x, t)` takes x (B, T, M) and t (B,) f32 model timesteps.  The solver
coefficients are computed in f32 from the `NoiseSchedule` tables, as in the
JAX version, and applied to x as Python floats.
"""

from __future__ import annotations

from typing import Callable

import torch

from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import NoiseSchedule

__all__ = ["dpmpp_sample"]

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _data_pred_fn(eps_fn: EpsFn, ns: NoiseSchedule, B: int):
    """x0-prediction wrapper (dpmsolver++ convention)."""

    def fn(x: torch.Tensor, t_cont: torch.Tensor) -> torch.Tensor:
        t_model = torch.full((B,), float(ns.to_model_t(t_cont)), dtype=torch.float32, device=x.device)
        # JAX promotes sigma (f32 array) * eps (model dtype) to f32
        eps = eps_fn(x, t_model).to(x.dtype)
        alpha = float(ns.marginal_alpha(t_cont))
        sigma = float(ns.marginal_std(t_cont))
        return (x - sigma * eps) / alpha

    return fn


def dpmpp_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2
) -> torch.Tensor:
    """Multistep DPM-Solver++ of order 1 or 2: `steps` model evaluations."""
    if order not in (1, 2):
        raise NotImplementedError(f"dpmpp_sample order {order}: only orders 1-2 are ported (ROADMAP.md)")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    ts = torch.linspace(ns.T, 1.0 / ns.total_N, steps + 1, dtype=torch.float32)
    lambdas = ns.marginal_lambda(ts)
    sigmas = ns.marginal_std(ts)
    alphas = ns.marginal_alpha(ts)

    m_0 = model(x, ts[0])
    m_1 = None
    h_prev = torch.tensor(1.0)
    for idx in range(steps):
        h = lambdas[idx + 1] - lambdas[idx]
        phi_1 = torch.expm1(-h)
        step_order = min(idx + 1, order)
        if steps < 10:
            step_order = min(step_order, steps - idx)
        x = float(sigmas[idx + 1] / sigmas[idx]) * x - float(alphas[idx + 1] * phi_1) * m_0
        if step_order >= 2:
            r0 = h_prev / h
            d1 = (m_0 - m_1) / float(r0)
            x = x + float(-0.5 * (alphas[idx + 1] * phi_1)) * d1
        h_prev = h
        if idx + 1 < steps:
            m_0, m_1 = model(x, ts[idx + 1]), m_0
    return x
