"""Rational-rate polyphase sinc resampling as a strided convolution.

Counterpart of `latent_diffusion_speech_tpu/ops/resample.py`: a
Hann-windowed-sinc polyphase filter bank, built once per (orig, new) rate
pair on the host in numpy, applied as one strided `F.conv1d` whose output
channels are the phases.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resample", "resample_kernel"]


@lru_cache(maxsize=64)
def resample_kernel(
    orig_sr: int,
    new_sr: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
):
    """Polyphase kernels. Returns (kernels (new, 1, 2 * width + orig) f32
    numpy, width, orig, new), with orig / new the rates over their gcd."""
    gcd = math.gcd(orig_sr, new_sr)
    orig = orig_sr // gcd
    new = new_sr // gcd

    base_freq = min(orig, new) * rolloff / 2.0
    cutoff = base_freq / orig  # normalised to the input rate
    width = int(math.ceil(lowpass_filter_width / (2.0 * cutoff)))

    # output sample n = k * new + p lands at input time k * orig + p * orig / new,
    # so each phase-p kernel covers [-width, width + orig) around k * orig
    idx = np.arange(-width, width + orig, dtype=np.float64)
    phases = np.arange(new, dtype=np.float64)[:, None] * orig / new
    t = idx[None, :] - phases

    x = np.clip(2.0 * cutoff * t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(np.pi * x / lowpass_filter_width / 2.0) ** 2
    kernels = (2.0 * cutoff * window * np.sinc(x)).astype(np.float32)
    return kernels[:, None, :], width, orig, new


def resample(x: torch.Tensor, orig_sr: int, new_sr: int, **kw) -> torch.Tensor:
    """Resample the last axis from orig_sr to new_sr. Input (..., T);
    output (..., ceil(T * new / orig)), in x's dtype (computed in f32)."""
    if orig_sr == new_sr:
        return x
    kernels, width, orig, new = resample_kernel(orig_sr, new_sr, **kw)
    batch_shape, T = x.shape[:-1], x.shape[-1]
    y = F.pad(x.reshape(-1, 1, T).float(), (width, width + orig))
    out = F.conv1d(y, torch.from_numpy(kernels).to(y.device), stride=orig)  # (B, new, frames)
    out = out.transpose(1, 2).reshape(out.shape[0], -1)
    target_len = int(math.ceil(T * new / orig))
    return out[:, :target_len].reshape(batch_shape + (target_len,)).to(x.dtype)
