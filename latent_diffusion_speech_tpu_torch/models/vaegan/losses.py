"""GAN, VAE and spectral losses for codec training.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/losses.py`: LSGAN
discriminator and generator losses, the x2-weighted L1 feature-matching
loss (the real features taken as constants), KL(q(z|x) || N(0, 1)) summed
over channels, and the single- and fixed-multi-scale spectral losses
(normalised magnitude STFT, center=False, hop = n_fft).  Each discriminator's
logits and feature maps may be in any layout: the means do not depend on it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from latent_diffusion_speech_tpu_torch.ops.stft import hann_window, stft

__all__ = [
    "discriminator_loss",
    "generator_loss",
    "feature_loss",
    "kl_loss",
    "sss_loss",
    "rss_loss",
]


def discriminator_loss(real_logits: List[torch.Tensor], fake_logits: List[torch.Tensor]):
    """LSGAN: real -> 1, fake -> 0; (total, [(real term, fake term)])."""
    loss = 0.0
    per_disc = []
    for dr, dg in zip(real_logits, fake_logits):
        r = ((1.0 - dr.float()) ** 2).mean()
        g = (dg.float() ** 2).mean()
        loss = loss + r + g
        per_disc.append((r, g))
    return loss, per_disc


def generator_loss(fake_logits: List[torch.Tensor]):
    """LSGAN generator: fake -> 1; (total, [term per discriminator])."""
    loss = 0.0
    per_disc = []
    for dg in fake_logits:
        term = ((1.0 - dg.float()) ** 2).mean()
        loss = loss + term
        per_disc.append(term)
    return loss, per_disc


def feature_loss(fmap_real, fmap_fake) -> torch.Tensor:
    """L1 feature matching over every layer of every discriminator, x2;
    the real features are constants."""
    loss = 0.0
    for fr, fg in zip(fmap_real, fmap_fake):
        for rl, gl in zip(fr, fg):
            loss = loss + (rl.detach().float() - gl.float()).abs().mean()
    return loss * 2.0


def kl_loss(logs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_c (m^2 + e^logs - logs - 1), mean over batch and time."""
    return (0.5 * (m**2 + torch.exp(logs) - logs - 1.0).sum(dim=-1)).mean()


def sss_loss(x_true: torch.Tensor, x_pred: torch.Tensor, n_fft: int, alpha: float = 1.0,
             eps: float = 1e-7) -> torch.Tensor:
    """Single-scale spectral loss: spectral convergence + alpha x log-L1 of
    the normalised magnitude STFT (center=False, hop = n_fft)."""
    window = hann_window(n_fft, device=x_true.device)
    norm = torch.sqrt((window**2).sum())

    def mag(x):
        s = stft(x, n_fft, n_fft, window=window, center=False)
        # smoothed magnitude: |.| has a NaN gradient at exactly 0 (silence)
        return torch.sqrt(s.real**2 + s.imag**2 + 1e-12) / norm + eps

    st, sp = mag(x_true), mag(x_pred)
    B = st.shape[0]
    converge = (torch.linalg.vector_norm((st - sp).reshape(B, -1), dim=-1)
                / torch.linalg.vector_norm((st + sp).reshape(B, -1), dim=-1)).mean()
    log_term = (torch.log(st) - torch.log(sp)).abs().mean()
    return converge + alpha * log_term


def rss_loss(
    x_pred: torch.Tensor,
    x_true: torch.Tensor,
    scales: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
    alpha: float = 1.0,
) -> torch.Tensor:
    """Mean of `sss_loss` over the scales no longer than the signal."""
    usable = [s for s in scales if s <= x_true.shape[-1]]
    if not usable:
        raise ValueError(f"no usable FFT scale for signal length {x_true.shape[-1]}")
    total = 0.0
    for n_fft in usable:
        total = total + sss_loss(x_true, x_pred, n_fft, alpha=alpha)
    return total / len(usable)
