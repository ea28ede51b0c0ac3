"""DPM-Solver++ (multistep, orders 1-2) and UniPC as Python loops.

Counterparts of `latent_diffusion_speech_tpu/models/diffusion/samplers.py`:
* `dpmpp_sample` (time-uniform steps; the order builds up over the first
  steps and is lowered at the last steps only when steps < 10);
* `unipc_sample` (bh1/bh2 multistep predictor-corrector of order 1 or 2,
  the order lowered at the last steps, no corrector at the last step).
The other samplers of the JAX package (DDPM, DDIM, PLMS, singlestep and
adaptive DPM-Solver, UniPC with varying coefficients) are not ported yet;
see ROADMAP.md.

`eps_fn(x, t)` takes x (B, T, M) and t (B,) f32 model timesteps.  The solver
coefficients are computed in f32 from the `NoiseSchedule` tables, as in the
JAX version, and applied to x as Python floats.
"""

from __future__ import annotations

from typing import Callable

import torch

from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import NoiseSchedule

__all__ = ["dpmpp_sample", "unipc_sample"]

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


def unipc_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2, variant: str = "bh2"
) -> torch.Tensor:
    """UniPC of order 1 or 2 (B_h = -h for "bh1", expm1(-h) for "bh2"): a
    predictor on every step, the corrector on the first steps - 1 (each
    reusing the model evaluation at the predicted point as the next step's
    history), the last step returning the predictor: `steps` model
    evaluations."""
    if order not in (1, 2):
        raise NotImplementedError(f"unipc_sample order {order}: only orders 1-2 are ported (ROADMAP.md)")
    if variant not in ("bh1", "bh2"):
        raise ValueError(f"unipc_sample variant {variant!r}: 'bh1' or 'bh2'")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    ts = torch.linspace(ns.T, 1.0 / ns.total_N, steps + 1, dtype=torch.float32)
    lambdas = ns.marginal_lambda(ts)
    sigmas = ns.marginal_std(ts)
    alphas = ns.marginal_alpha(ts)

    m_0 = model(x, ts[0])
    m_1 = None
    for idx in range(steps):
        alpha_t = alphas[idx + 1]
        h = lambdas[idx + 1] - lambdas[idx]
        hh = -h
        h_phi_1 = torch.expm1(hh)
        b_h = h_phi_1 if variant == "bh2" else hh
        order2 = min(idx + 1, order, steps - idx) >= 2
        x_t_ = float(sigmas[idx + 1] / sigmas[idx]) * x - float(alpha_t * h_phi_1) * m_0
        if order2:
            r0 = (lambdas[idx - 1] - lambdas[idx]) / h
            d1 = (m_1 - m_0) / float(r0)
            x_pred = x_t_ - float(alpha_t * b_h * 0.5) * d1
        else:
            x_pred = x_t_
        if idx + 1 == steps:
            return x_pred
        m_t = model(x_pred, ts[idx + 1])
        # corrector: order 2 solves [[1, 1], [r0, 1]] rhos = [b1, b2]; order 1 uses rho = 0.5
        if order2:
            h_phi_k1 = h_phi_1 / hh - 1.0
            b1 = h_phi_k1 / b_h
            b2 = (h_phi_k1 / hh - 0.5) * 2.0 / b_h
            rc_d1 = (b1 - b2) / (1.0 - r0)
            rc_dt = b2 - rc_d1 * r0
            x = x_t_ - float(alpha_t * b_h * rc_d1) * d1 - float(alpha_t * b_h * rc_dt) * (m_t - m_0)
        else:
            x = x_t_ - float(alpha_t * b_h * 0.5) * (m_t - m_0)
        m_0, m_1 = m_t, m_0
    return x
