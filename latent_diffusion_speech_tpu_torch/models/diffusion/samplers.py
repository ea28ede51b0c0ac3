"""The sampler suite as Python loops.

Counterparts of `latent_diffusion_speech_tpu/models/diffusion/samplers.py`,
function for function, with the same names and arguments (the JAX `rng` key
of `ddpm_sample` becomes a `torch.Generator`):
* `ddpm_sample`: ancestral sampling, posterior mean with x0 clamped to
  [-1, 1], log-variance noise, no noise at t=0;
* `ddim_sample` and `plms_sample` (PNDM: the Adams-Bashforth ladders, two
  model evaluations on the first step);
* `dpmpp_sample`: multistep DPM-Solver++ of order 1-3 (time-uniform steps;
  the order builds up over the first steps and is lowered at the last steps
  only when steps < 10);
* `unipc_sample`: bh1/bh2 multistep predictor-corrector of order 1 or 2
  (the order lowered at the last steps, no corrector at the last step);
* `singlestep_orders` and `dpmpp_singlestep_sample` (DPM-Solver-fast: blocks
  of mixed order over the `_singlestep_updates`);
* `dpmpp_adaptive_sample`: adaptive step size over embedded lower/higher
  order pairs.  Its step count depends on the data, so the host reads the
  error norm of every step (one synchronisation a step), as the JAX
  `lax.while_loop` does on its device;
* `unipc_vary_sample`: UniPC with the Vandermonde-solved (vary_coeff)
  coefficients.

`eps_fn(x, t)` takes x (B, T, M) and t (B,): int64 timesteps for the
discrete samplers (DDPM, DDIM, PLMS), f32 model timesteps for the
continuous ones.  Coefficients are computed in f32, from the
`DiffusionSchedule` tables (numpy f32) or the `NoiseSchedule` (f32
tensors), as the JAX version computes them, and applied to x as Python
floats, so x keeps its dtype.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import DiffusionSchedule, NoiseSchedule

__all__ = [
    "ddpm_sample",
    "ddim_sample",
    "plms_sample",
    "dpmpp_sample",
    "unipc_sample",
    "singlestep_orders",
    "dpmpp_singlestep_sample",
    "dpmpp_adaptive_sample",
    "unipc_vary_sample",
]

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _timesteps(x: torch.Tensor, i: int) -> torch.Tensor:
    return torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)


def _normal(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) noise shaped and typed like x (drawn in f32)."""
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32).to(x.dtype)


def _linspace(start, stop, num: int) -> torch.Tensor:
    """jnp.linspace in f32: start * (1 - i/(num-1)) + stop * i/(num-1), the
    last point exactly `stop`."""
    start = torch.as_tensor(start, dtype=torch.float32)
    stop = torch.as_tensor(stop, dtype=torch.float32)
    if num == 1:
        return start[None]
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


# ---------------------------------------------------------------------------
# DDPM ancestral
# ---------------------------------------------------------------------------

def ddpm_sample(
    eps_fn: EpsFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """t_max model evaluations, t = t_max-1 .. 0; noise from `generator`
    (drawn at every step, unused at t=0, as in the JAX loop)."""
    for i in range(t_max - 1, -1, -1):
        eps = eps_fn(x, _timesteps(x, i)).to(x.dtype)
        x0 = float(sched.sqrt_recip_alphas_cumprod[i]) * x - float(sched.sqrt_recipm1_alphas_cumprod[i]) * eps
        x0 = x0.clamp(-1.0, 1.0)
        mean = float(sched.posterior_mean_coef1[i]) * x0 + float(sched.posterior_mean_coef2[i]) * x
        noise = _normal(x, generator)
        x = mean + float(np.exp(0.5 * sched.posterior_log_variance_clipped[i])) * noise if i > 0 else mean
    return x


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def ddim_sample(
    eps_fn: EpsFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int, speedup: int
) -> torch.Tensor:
    ac = sched.alphas_cumprod
    for i in range(t_max - speedup, -1, -speedup):
        a_t, a_prev = ac[i], ac[max(i - speedup, 0)]
        eps = eps_fn(x, _timesteps(x, i)).to(x.dtype)
        c_eps = np.sqrt((1 - a_prev) / a_prev) - np.sqrt((1 - a_t) / a_t)
        x = float(np.sqrt(a_prev)) * (x / float(np.sqrt(a_t)) + float(c_eps) * eps)
    return x


# ---------------------------------------------------------------------------
# PLMS / PNDM
# ---------------------------------------------------------------------------

def plms_sample(
    eps_fn: EpsFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int, speedup: int
) -> torch.Tensor:
    ac = sched.alphas_cumprod

    def x_pred(x, noise_t, i):
        a_t, a_prev = ac[i], ac[max(i - speedup, 0)]
        a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
        c_x = 1.0 / (a_t_sq * (a_t_sq + a_prev_sq))
        c_n = 1.0 / (a_t_sq * (np.sqrt((1 - a_prev) * a_t) + np.sqrt((1 - a_t) * a_prev)))
        return x + float(a_prev - a_t) * (float(c_x) * x - float(c_n) * noise_t)

    history: List[torch.Tensor] = []  # the previous steps' eps, newest first
    for i in range(t_max - speedup, -1, -speedup):
        eps = eps_fn(x, _timesteps(x, i)).to(x.dtype)
        if not history:
            # first step: a second evaluation at t - speedup for a 2-point average
            eps_prev = eps_fn(x_pred(x, eps, i), _timesteps(x, max(i - speedup, 0))).to(x.dtype)
            eps_prime = (eps + eps_prev) / 2
        elif len(history) == 1:
            eps_prime = (3 * eps - history[0]) / 2
        elif len(history) == 2:
            eps_prime = (23 * eps - 16 * history[0] + 5 * history[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * history[0] + 37 * history[1] - 9 * history[2]) / 24
        x = x_pred(x, eps_prime, i)
        history = [eps] + history[:2]
    return x


# ---------------------------------------------------------------------------
# continuous-time helpers (shared by DPM-Solver++ and UniPC)
# ---------------------------------------------------------------------------

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


def _time_grid(ns: NoiseSchedule, steps: int) -> torch.Tensor:
    return _linspace(ns.T, 1.0 / ns.total_N, steps + 1)


# ---------------------------------------------------------------------------
# DPM-Solver++ (multistep, orders 1-3, time_uniform)
# ---------------------------------------------------------------------------

def dpmpp_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2
) -> torch.Tensor:
    """Multistep DPM-Solver++ of order 1, 2 or 3: `steps` model evaluations."""
    if order not in (1, 2, 3):
        raise ValueError(f"dpmpp_sample order {order}: 1, 2 or 3")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    ts = _time_grid(ns, steps)
    lambdas = ns.marginal_lambda(ts)
    sigmas = ns.marginal_std(ts)
    alphas = ns.marginal_alpha(ts)

    m_0 = model(x, ts[0])
    m_1 = m_2 = None
    h_prev = h_prev2 = torch.tensor(1.0)  # λ_{i-1}-λ_{i-2}, λ_{i-2}-λ_{i-3}
    for idx in range(steps):
        alpha_t = alphas[idx + 1]
        h = lambdas[idx + 1] - lambdas[idx]
        phi_1 = torch.expm1(-h)
        step_order = min(idx + 1, order)
        if steps < 10:
            step_order = min(step_order, steps - idx)
        x = float(sigmas[idx + 1] / sigmas[idx]) * x - float(alpha_t * phi_1) * m_0
        if step_order >= 2:
            r0 = h_prev / h
            d1_0 = (m_0 - m_1) / float(r0)
            if step_order == 2:
                x = x + float(-0.5 * (alpha_t * phi_1)) * d1_0
            else:
                r1 = h_prev2 / h
                d1_1 = (m_1 - m_2) / float(r1)
                d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
                d2 = (d1_0 - d1_1) / float(r0 + r1)
                phi_2 = phi_1 / h + 1.0
                phi_3 = phi_2 / h - 0.5
                x = x + (float(alpha_t * phi_2) * d1 - float(alpha_t * phi_3) * d2)
        h_prev, h_prev2 = h, h_prev
        if idx + 1 < steps:
            m_0, m_1, m_2 = model(x, ts[idx + 1]), m_0, m_1
    return x


# ---------------------------------------------------------------------------
# UniPC (bh1/bh2, multistep order 1-2, predictor-corrector)
# ---------------------------------------------------------------------------

def unipc_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2, variant: str = "bh2"
) -> torch.Tensor:
    """UniPC of order 1 or 2 (B_h = -h for "bh1", expm1(-h) for "bh2"): a
    predictor on every step, the corrector on the first steps - 1 (each
    reusing the model evaluation at the predicted point as the next step's
    history), the last step returning the predictor: `steps` model
    evaluations."""
    if order not in (1, 2):
        raise ValueError(f"unipc_sample order {order}: 1 or 2")
    if variant not in ("bh1", "bh2"):
        raise ValueError(f"unipc_sample variant {variant!r}: 'bh1' or 'bh2'")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    ts = _time_grid(ns, steps)
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


# ---------------------------------------------------------------------------
# DPM-Solver++ singlestep ("DPM-Solver-fast": mixed orders 1-3)
# ---------------------------------------------------------------------------

def _singlestep_updates(model, ns: NoiseSchedule):
    """The three dpmsolver++ singlestep updates.  Each takes continuous
    times (s, t) as f32 scalars and runs its own intermediate model
    evaluations; each returns (x_t, the evaluations a caller may reuse)."""

    def first(x, s, t, model_s=None):
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        sig_s, sig_t = ns.marginal_std(s), ns.marginal_std(t)
        alpha_t = ns.marginal_alpha(t)
        phi_1 = torch.expm1(-(lam_t - lam_s))
        if model_s is None:
            model_s = model(x, s)
        return float(sig_t / sig_s) * x - float(alpha_t * phi_1) * model_s, model_s

    def second(x, s, t, r1=0.5, model_s=None):
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        sig_s, sig_s1, sig_t = ns.marginal_std(s), ns.marginal_std(s1), ns.marginal_std(t)
        alpha_s1, alpha_t = ns.marginal_alpha(s1), ns.marginal_alpha(t)
        phi_11 = torch.expm1(-r1 * h)
        phi_1 = torch.expm1(-h)
        if model_s is None:
            model_s = model(x, s)
        x_s1 = float(sig_s1 / sig_s) * x - float(alpha_s1 * phi_11) * model_s
        model_s1 = model(x_s1, s1)
        x_t = (
            float(sig_t / sig_s) * x
            - float(alpha_t * phi_1) * model_s
            - float((0.5 / r1) * (alpha_t * phi_1)) * (model_s1 - model_s)
        )
        return x_t, (model_s, model_s1)

    def third(x, s, t, r1=1.0 / 3, r2=2.0 / 3, model_s=None, model_s1=None):
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        sig_s, sig_s1, sig_s2, sig_t = (
            ns.marginal_std(s), ns.marginal_std(s1), ns.marginal_std(s2), ns.marginal_std(t)
        )
        alpha_s1, alpha_s2, alpha_t = ns.marginal_alpha(s1), ns.marginal_alpha(s2), ns.marginal_alpha(t)
        phi_11 = torch.expm1(-r1 * h)
        phi_12 = torch.expm1(-r2 * h)
        phi_1 = torch.expm1(-h)
        phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        if model_s is None:
            model_s = model(x, s)
        if model_s1 is None:
            x_s1 = float(sig_s1 / sig_s) * x - float(alpha_s1 * phi_11) * model_s
            model_s1 = model(x_s1, s1)
        x_s2 = (
            float(sig_s2 / sig_s) * x
            - float(alpha_s2 * phi_12) * model_s
            + float((r2 / r1) * (alpha_s2 * phi_22)) * (model_s1 - model_s)
        )
        model_s2 = model(x_s2, s2)
        x_t = (
            float(sig_t / sig_s) * x
            - float(alpha_t * phi_1) * model_s
            + float((1.0 / r2) * (alpha_t * phi_2)) * (model_s2 - model_s)
        )
        return x_t, (model_s, model_s1)

    return first, second, third


def singlestep_orders(steps: int, order: int):
    """Order list for DPM-Solver-fast."""
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (K - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (K - 1) + [1]
        return [3] * (K - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    if order == 1:
        return [1] * steps
    raise ValueError("'order' must be 1, 2 or 3")


def dpmpp_singlestep_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2
) -> torch.Tensor:
    """Singlestep DPM-Solver++ ("DPM-Solver-fast", time-uniform): `steps`
    model evaluations split into blocks of the given max order."""
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    first, second, third = _singlestep_updates(model, ns)
    orders = singlestep_orders(steps, order)
    outer = _time_grid(ns, steps)[torch.as_tensor(np.cumsum([0] + orders))]
    for i, o in enumerate(orders):
        s, t = outer[i], outer[i + 1]
        # r1/r2 from the lambda spacing of a time-uniform inner grid
        lam = ns.marginal_lambda(_linspace(s, t, o + 1))
        h = lam[-1] - lam[0]
        if o == 1:
            x, _ = first(x, s, t)
        elif o == 2:
            x, _ = second(x, s, t, r1=(lam[1] - lam[0]) / h)
        else:
            x, _ = third(x, s, t, r1=(lam[1] - lam[0]) / h, r2=(lam[2] - lam[0]) / h)
    return x


def dpmpp_adaptive_sample(
    eps_fn: EpsFn,
    ns: NoiseSchedule,
    x: torch.Tensor,
    order: int = 2,
    h_init: float = 0.05,
    atol: float = 0.0078,
    rtol: float = 0.05,
    theta: float = 0.9,
    t_err: float = 1e-5,
    max_iters: int = 200,
) -> torch.Tensor:
    """Adaptive step-size DPM-Solver++: embedded (order-1, order-2) or
    (order-2, order-3) pairs, a step accepted when the scaled local-error
    RMS (the largest over the batch) is <= 1, the logSNR step adapted by
    theta * E^(-1/order); at most `max_iters` attempts.  A host loop: each
    attempt reads E from the device."""
    if order not in (2, 3):
        raise ValueError(f"dpmpp_adaptive_sample order {order}: 2 or 3")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    first, second, third = _singlestep_updates(model, ns)
    t_0 = 1.0 / ns.total_N
    lambda_0 = ns.marginal_lambda(torch.tensor(t_0))

    def lower_higher(x, s, t):
        if order == 2:
            x_low, model_s = first(x, s, t)
            x_high, _ = second(x, s, t, model_s=model_s)
        else:
            # r1=1/3 so the lower update's intermediate evaluation is shared
            # with the third-order update
            x_low, (model_s, model_s1) = second(x, s, t, r1=1.0 / 3)
            x_high, _ = third(x, s, t, model_s=model_s, model_s1=model_s1)
        return x_low, x_high

    x_prev = x
    s = torch.tensor(ns.T, dtype=torch.float32)
    h = torch.tensor(h_init, dtype=torch.float32)
    it = 0
    while bool(torch.abs(s - t_0) > t_err) and it < max_iters:
        t = ns.inverse_lambda(ns.marginal_lambda(s) + h)
        x_low, x_high = lower_higher(x, s, t)
        delta = (rtol * torch.maximum(x_low.abs(), x_prev.abs())).clamp_min(atol)
        err = ((x_high - x_low) / delta).reshape(B, -1)
        E = err.pow(2).mean(dim=-1).sqrt().max().float().cpu()
        if bool(E <= 1.0):
            x, x_prev, s = x_high, x_low, t
        h = torch.minimum(theta * h * E ** (-1.0 / order), lambda_0 - ns.marginal_lambda(s))
        it += 1
    return x


# ---------------------------------------------------------------------------
# UniPC vary-coeff (order 1-2)
# ---------------------------------------------------------------------------

def unipc_vary_sample(
    eps_fn: EpsFn, ns: NoiseSchedule, x: torch.Tensor, steps: int, order: int = 2
) -> torch.Tensor:
    """UniPC variant 'vary_coeff', multistep order <= 2, corrector on every
    step but the last: the loop of `unipc_sample` with the
    Vandermonde-solved coefficients.  Order 2: C = [[1, r0/2], [1, 1/2]],
    A_p = [[1]], A_c = inv(C); phi_{k+1} = phi_k / (-h) - 1/k!."""
    if order not in (1, 2):
        raise ValueError(f"unipc_vary_sample order {order}: 1 or 2")
    B = x.shape[0]
    model = _data_pred_fn(eps_fn, ns, B)
    ts = _time_grid(ns, steps)
    lambdas = ns.marginal_lambda(ts)
    sigmas = ns.marginal_std(ts)
    alphas = ns.marginal_alpha(ts)

    m_0 = model(x, ts[0])
    m_1 = None
    for idx in range(steps):
        alpha_t = alphas[idx + 1]
        h = lambdas[idx + 1] - lambdas[idx]
        hh = -h
        phi_1 = torch.expm1(hh)
        phi_2 = phi_1 / hh - 1.0
        phi_3 = phi_2 / hh - 0.5
        is2 = min(idx + 1, order, steps - idx) >= 2
        x_t_ = float(sigmas[idx + 1] / sigmas[idx]) * x - float(alpha_t * phi_1) * m_0
        if is2:
            r0 = (lambdas[idx - 1] - lambdas[idx]) / h
            d1_0 = (m_1 - m_0) / float(r0)
            # predictor: A_p = [[1]] -> one phi_2 D1_0 residual
            x_pred = x_t_ - float(alpha_t * phi_2) * d1_0
        else:
            x_pred = x_t_
        if idx + 1 == steps:
            return x_pred
        m_t = model(x_pred, ts[idx + 1])
        d1_t = m_t - m_0
        if is2:
            # corrector rows of A_c = inv([[1, r0/2], [1, 1/2]])
            det = (1.0 - r0) / 2.0 if float(r0) != 1.0 else torch.tensor(1.0)
            a00 = 0.5 / det
            a01 = -r0 / (2.0 * det)
            x = x_t_ - float(alpha_t * phi_2) * (float(a00) * d1_0) - float(alpha_t * phi_3) * (float(a01) * d1_t)
        else:
            x = x_t_ - float(alpha_t * phi_2) * d1_t  # K=1 corrector: A_c = [[1]]
        m_0, m_1 = m_t, m_0
    return x
