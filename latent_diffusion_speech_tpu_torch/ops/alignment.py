"""Re-timing semantic units onto the latent frame grid (host side, numpy).

Counterpart of `latent_diffusion_speech_tpu/ops/alignment.py::units_forced_alignment`,
which does the same arithmetic in `jax.numpy`: units at the encoder frame
rate (16 kHz / 320) are re-timed onto the vocoder latent grid (44.1 kHz /
512) by 'nearest' or 'linear' interpolation over the frame axis (torch
F.interpolate semantics) or by the 'left' gather.  Positions are computed in
f32, as the JAX version computes them, so both pick the same frames.
"""

from __future__ import annotations

import numpy as np

__all__ = ["units_forced_alignment"]


def _interp_nearest(units: np.ndarray, n_frames: int) -> np.ndarray:
    """F.interpolate(mode='nearest') over axis 1 of (B, T, C)."""
    T = units.shape[1]
    idx = np.floor(np.arange(n_frames, dtype=np.float32) * np.float32(T / n_frames)).astype(np.int32)
    return units[:, np.clip(idx, 0, T - 1), :]


def _interp_linear(units: np.ndarray, n_frames: int) -> np.ndarray:
    """F.interpolate(mode='linear', align_corners=False) over axis 1."""
    T = units.shape[1]
    pos = (np.arange(n_frames, dtype=np.float32) + np.float32(0.5)) * np.float32(T / n_frames) - np.float32(0.5)
    pos = np.clip(pos, np.float32(0.0), np.float32(T - 1.0))
    i0 = np.floor(pos).astype(np.int32)
    i1 = np.minimum(i0 + 1, T - 1)
    w = (pos - i0.astype(np.float32))[None, :, None]
    return units[:, i0, :] * (1 - w) + units[:, i1, :] * w


def units_forced_alignment(
    units: np.ndarray,
    n_frames: int | None = None,
    audio_len: int | None = None,
    hop_size: int | None = None,
    scale_factor: float | None = None,
    mode: str = "nearest",
) -> np.ndarray:
    """Align units (..., T_units, C) to n_frames along the time axis.

    n_frames defaults to audio_len // hop_size + 1 (the latent frame count
    convention of the pipeline)."""
    if n_frames is None:
        if audio_len is not None and hop_size is not None:
            n_frames = int(audio_len // hop_size + 1)
        elif scale_factor is not None:
            n_frames = int(units.shape[-2] * scale_factor)
        else:
            raise ValueError("need n_frames, (audio_len, hop_size), or scale_factor")

    x = np.asarray(units)
    squeezed = x.ndim == 2
    if squeezed:
        x = x[None]

    if mode == "left":
        sf = scale_factor if scale_factor is not None else x.shape[1] / n_frames
        pos = np.round(np.float32(sf) * np.arange(n_frames, dtype=np.float32)).astype(np.int32)
        out = x[:, np.clip(pos, 0, x.shape[1] - 1), :]
    elif mode in ("nearest", "rfa441to512", "rfa512to441"):
        out = _interp_nearest(x, n_frames)
    elif mode == "linear":
        out = _interp_linear(x, n_frames)
    else:
        raise ValueError(f"unknown units_forced_mode: {mode!r}")
    return out[0] if squeezed else out
