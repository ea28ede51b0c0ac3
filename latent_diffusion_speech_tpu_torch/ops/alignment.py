"""Re-timing semantic units onto the latent frame grid (host side, numpy).

Counterpart of `latent_diffusion_speech_tpu/ops/alignment.py::units_forced_alignment`,
which does the same arithmetic in `jax.numpy`: units at the encoder frame
rate (16 kHz / 320) are re-timed onto the vocoder latent grid (44.1 kHz /
512) by 'nearest' or 'linear' interpolation over the frame axis (torch
F.interpolate semantics) or by the 'left' gather.  Positions are computed in
f32, as the JAX version computes them, so both pick the same frames.

`cross_fade` is the long-audio stitcher (`tools/tools.py:231-238`), a copy
of the JAX package's numpy function.
"""

from __future__ import annotations

import numpy as np

__all__ = ["units_forced_alignment", "cross_fade"]


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


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Linear cross-fade of segment b into a starting at sample idx
    (reference `tools/tools.py:231-238`)."""
    result = np.zeros(idx + b.shape[0], dtype=np.result_type(a, b))
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx : a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0] :] = b[fade_len:]
    return result
