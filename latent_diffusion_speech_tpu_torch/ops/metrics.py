"""Fidelity metrics.

Counterpart of `latent_diffusion_speech_tpu/ops/metrics.py`: `mcd`, the
mel-cepstral distortion in dB between two log-mel sequences (DCT-II of the
log-mel frames, the euclidean distance over cepstral coefficients 1..K,
scaled by 10 sqrt(2) / ln 10), and `log_spectral_distance`, the RMS
log-spectral distance in dB.  Plain PyTorch on the tensors' device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mcd", "log_spectral_distance"]

_MCD_SCALE = 10.0 * math.sqrt(2.0) / math.log(10.0)


def _dct2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis."""
    n = x.shape[-1]
    k = torch.arange(n, device=x.device)
    basis = torch.cos(math.pi / n * (torch.arange(n, device=x.device)[:, None] + 0.5) * k[None, :])  # (n, K)
    out = x @ basis.to(x.dtype)
    scale = torch.where(k == 0, math.sqrt(1.0 / (4 * n)), math.sqrt(1.0 / (2 * n))) * 2.0
    return out * scale.to(x.dtype)


def mcd(log_mel_a: torch.Tensor, log_mel_b: torch.Tensor, n_coeffs: int = 13) -> torch.Tensor:
    """Mean MCD in dB over frames. Inputs (..., T, n_mels) natural-log mel."""
    ca = _dct2(log_mel_a)[..., 1 : n_coeffs + 1]
    cb = _dct2(log_mel_b)[..., 1 : n_coeffs + 1]
    dist = torch.sqrt(torch.sum((ca - cb) ** 2, dim=-1))
    return _MCD_SCALE * torch.mean(dist)


def log_spectral_distance(log_mel_a: torch.Tensor, log_mel_b: torch.Tensor) -> torch.Tensor:
    """RMS log-spectral distance in dB over frames (secondary fidelity metric)."""
    diff_db = (log_mel_a - log_mel_b) * (10.0 / math.log(10.0))
    return torch.mean(torch.sqrt(torch.mean(diff_db**2, dim=-1)))
