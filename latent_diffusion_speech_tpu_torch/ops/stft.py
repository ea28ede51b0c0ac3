"""STFT and the Whisper log-mel front-end.

Counterpart of `latent_diffusion_speech_tpu/ops/stft.py` (`hann_window`,
`frame`, `stft`, `whisper_log_mel`): the same framing, window and padding
arithmetic, with `torch.fft.rfft` in place of `jnp.fft.rfft`.  The
HiFi-VAEGAN `MelSpectrogram` and `istft` wait for the codec encoder
(ROADMAP.md).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.ops.mel import mel_filterbank

__all__ = ["hann_window", "frame", "stft", "whisper_log_mel",
           "WHISPER_SAMPLE_RATE", "WHISPER_N_FFT", "WHISPER_HOP"]

# Whisper front-end constants (`encoder/whisper/audio.py:9-13`)
WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_HOP = 160


def hann_window(win_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default)."""
    n = torch.arange(win_size, dtype=torch.float32, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_size)).to(dtype)


def frame(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Frame the last axis into (..., n_frames, frame_length) windows."""
    return y.unfold(-1, frame_length, hop)


def _pad_last(y: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """F.pad of the last axis for any number of leading axes."""
    lead = y.shape[:-1]
    out = F.pad(y.reshape(-1, 1, y.shape[-1]), (left, right), mode=mode)
    return out.reshape(lead + out.shape[-1:])


def stft(
    y: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
) -> torch.Tensor:
    """torch.stft-compatible STFT. Input (..., T), output (..., n_freq,
    n_frames) complex64; onesided, not normalised, reflect-padded by
    n_fft // 2 on each side when `center`."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, device=y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        y = _pad_last(y, n_fft // 2, n_fft // 2, "reflect")
    frames = frame(y, n_fft, hop_length) * window.to(y.dtype)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


@lru_cache(maxsize=8)
def _whisper_filters(n_mels: int) -> np.ndarray:
    return mel_filterbank(WHISPER_SAMPLE_RATE, WHISPER_N_FFT, n_mels)


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 128, padding: int = 0) -> torch.Tensor:
    """Whisper log-mel (`encoder/whisper/audio.py:62-82`). Input (..., T)
    16 kHz; output (..., n_mels, T // 160), f32.  The floor of max - 8 is
    taken over the whole tensor, batch included, as the JAX function does."""
    audio = audio.float()
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    spec = stft(audio, WHISPER_N_FFT, WHISPER_HOP, center=True)
    mag = spec[..., :-1].abs() ** 2
    filters = torch.from_numpy(_whisper_filters(n_mels)).to(audio.device)
    mel = torch.einsum("mf,...ft->...mt", filters, mag)
    log_spec = torch.log10(mel.clamp(min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0
