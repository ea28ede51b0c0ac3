"""Frame-wise F0 (pitch) extraction: YIN over batched FFT autocorrelation.

Counterpart of `latent_diffusion_speech_tpu/ops/f0.py::extract_f0`, with the
same defaults and frame convention: the cumulative-mean-normalised
difference (de Cheveigné & Kawahara 2002) over candidate lags, for every
frame at once from FFT cross-correlations (`torch.fft` on the tensor's
device; no Pallas kernel is involved in the JAX function), the first lag
under the threshold descended to the bottom of its dip (else the global
minimum), and parabolic interpolation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["extract_f0"]


def extract_f0(
    audio: torch.Tensor,
    sr: int = 44100,
    hop_size: int = 512,
    win_size: int = 2048,
    f0_min: float = 40.0,
    f0_max: float = 1200.0,
    threshold: float = 0.15,
):
    """audio (..., T) -> (f0 (..., n_frames) f32, voiced (..., n_frames) bool).

    n_frames = T // hop_size + 1 (the pipeline's latent frame convention);
    unvoiced frames report f0 = 0."""
    audio = torch.as_tensor(audio).float()
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    B, T = audio.shape
    dev = audio.device

    n_frames = T // hop_size + 1
    pad = win_size  # centred frames, zero padding
    x = F.pad(audio, (pad // 2, pad))
    idx = (torch.arange(n_frames, device=dev) * hop_size)[:, None] + torch.arange(win_size, device=dev)[None, :]
    frames = x[:, idx]  # (B, n_frames, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)

    tau_max = min(int(sr / f0_min), win_size // 2)
    tau_min = max(int(sr / f0_max), 2)

    # d(tau) = sum_j (x_j - x_{j+tau})^2 over W = win - tau_max samples:
    # e0 + e_tau - 2 sum_j x_j x_{j+tau}, the last term an FFT cross-correlation
    W = win_size - tau_max
    n_fft = 1 << (win_size * 2 - 1).bit_length()
    spec = torch.fft.rfft(frames, n=n_fft)
    head = torch.fft.rfft(frames[..., :W], n=n_fft)
    corr = torch.fft.irfft(spec * torch.conj(head), n=n_fft)[..., : tau_max + 1]  # (B, F, tau)

    csq = torch.cumsum(frames**2, dim=-1)
    e0 = csq[..., W - 1]  # energy of x[0:W]
    pad_csq = F.pad(csq, (1, 0))
    taus = torch.arange(tau_max + 1, device=dev)
    e_tau = pad_csq[..., taus + W] - pad_csq[..., taus]  # energy of x[tau : tau + W]
    d = (e0[..., None] + e_tau - 2.0 * corr).clamp_min(0.0)  # (B, F, tau + 1)

    # cumulative mean normalised difference
    cum = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = d[..., 1:] * torch.arange(1, tau_max + 1, device=dev) / cum.clamp_min(1e-12)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)

    lag_ok = (taus >= tau_min) & (taus <= tau_max - 1)
    inf = torch.tensor(float("inf"), device=dev)
    masked = torch.where(lag_ok, cmnd, inf)

    # the first threshold crossing, descended to its dip's minimum within
    # [fc, 1.4 fc) (the crossing itself is early-biased); the global minimum
    # when nothing crosses
    below = masked < threshold
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)
    any_below = below.any(dim=-1)
    lo = first_below[..., None]
    hi = torch.clamp(torch.div(first_below * 7, 5, rounding_mode="floor") + 2, max=tau_max)[..., None]
    in_dip = (taus >= lo) & (taus < hi)
    dip_min = torch.argmin(torch.where(in_dip, masked, inf), dim=-1)
    best = torch.where(any_below, dip_min, torch.argmin(masked, dim=-1))

    # parabolic interpolation around the chosen lag
    b0 = best.clamp(1, tau_max - 1)
    dm = torch.gather(cmnd, -1, (b0 - 1)[..., None])[..., 0]
    dc = torch.gather(cmnd, -1, b0[..., None])[..., 0]
    dp = torch.gather(cmnd, -1, (b0 + 1)[..., None])[..., 0]
    denom = dm - 2 * dc + dp
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (dm - dp) / denom, torch.zeros_like(denom))
    tau_refined = b0.float() + shift.clamp(-1.0, 1.0)

    f0 = sr / tau_refined.clamp_min(1.0)
    min_cmnd = torch.gather(cmnd, -1, best[..., None])[..., 0]
    energy = e0 / W
    voiced = (min_cmnd < max(threshold * 2.0, 0.3)) & (energy > 1e-6) & (f0 >= f0_min) & (f0 <= f0_max)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))

    if squeeze:
        return f0[0], voiced[0]
    return f0, voiced
