"""Mel filterbank construction (librosa-compatible, no librosa dependency).

A copy of `latent_diffusion_speech_tpu/ops/mel.py` (numpy only).

The reference gets its filters from `librosa.filters.mel` (slaney scale +
slaney area normalization — `encoder/hifi_vaegan/modules/nvSTFT.py:91`) and
from whisper's prebuilt `assets/mel_filters.npz` (`encoder/whisper/audio.py:54-60`,
itself librosa-generated).  This is a from-scratch numpy implementation
golden-tested against that npz.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank"]


def hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mel = np.where(log_t, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(mel: np.ndarray, htk: bool = False) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mel >= min_log_mel
    freq = np.where(log_t, min_log_hz * np.exp(logstep * (mel - min_log_mel)), freq)
    return freq


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = sr / 2.0

    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_min = hz_to_mel(np.array(fmin), htk=htk)
    mel_max = hz_to_mel(np.array(fmax), htk=htk)
    mel_pts = mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2), htk=htk)

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm: {norm!r}")

    return weights.astype(dtype)
