"""STFT, its inverse, and the two mel front-ends.

Counterpart of `latent_diffusion_speech_tpu/ops/stft.py` (`hann_window`,
`frame`, `stft`, `istft`, `MelSpectrogram`, `whisper_log_mel`): the same
framing, window and padding arithmetic, with `torch.fft.rfft` /
`torch.fft.irfft` in place of `jnp.fft`, and `F.fold` as the overlap-add.
`MelSpectrogram` is the HiFi-VAEGAN log-mel (the reference's `nvSTFT.py`:
asymmetric (win - hop) // 2 padding, magnitude sqrt(re^2 + im^2 + 1e-9),
slaney mel, log with a 1e-5 clamp, the keyshift and speed rules).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.ops.mel import mel_filterbank

__all__ = ["hann_window", "frame", "stft", "istft", "MelSpectrogram", "whisper_log_mel",
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
    window = _padded_window(window, win_length or n_fft, n_fft, y.device)
    if center:
        y = _pad_last(y, n_fft // 2, n_fft // 2, "reflect")
    frames = frame(y, n_fft, hop_length) * window.to(y.dtype)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def _padded_window(window: Optional[torch.Tensor], win_length: int, n_fft: int, device) -> torch.Tensor:
    if window is None:
        window = hann_window(win_length, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT by overlap-add with squared-window normalisation
    (torch.istft semantics). Input (..., n_freq, n_frames) complex; output
    (..., T) real."""
    window = _padded_window(window, win_length or n_fft, n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * window.to(frames.dtype)
    batch_shape, n_frames = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)

    def overlap_add(fr: torch.Tensor) -> torch.Tensor:  # (B, n_frames, n_fft) -> (B, out_len)
        return F.fold(fr.transpose(1, 2), (1, out_len), (1, n_fft), stride=(1, hop_length))[:, 0, 0]

    out = overlap_add(frames.reshape(-1, n_frames, n_fft))
    wsq = (window.to(frames.dtype) ** 2).expand(1, n_frames, n_fft)
    out = out / overlap_add(wsq).clamp(min=1e-11)
    if center:
        out = out[:, n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        out = out[:, :length]
    return out.reshape(batch_shape + out.shape[1:])


class MelSpectrogram:
    """HiFi-VAEGAN log-mel front-end (reference `nvSTFT.py:55-118`)."""

    def __init__(
        self,
        sr: int = 44100,
        n_mels: int = 128,
        n_fft: int = 2048,
        win_size: int = 2048,
        hop_length: int = 512,
        fmin: float = 40.0,
        fmax: float = 16000.0,
        clip_val: float = 1e-5,
    ):
        self.sr = sr
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.win_size = win_size
        self.hop_length = hop_length
        self.fmin = fmin
        self.fmax = fmax
        self.clip_val = clip_val
        self.mel_basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax))

    def __call__(self, y: torch.Tensor, keyshift: float = 0.0, speed: float = 1.0) -> torch.Tensor:
        """Input (B, T) in [-1, 1]; output (B, n_mels, n_frames) log-mel, f32."""
        y = y.float()
        factor = 2.0 ** (keyshift / 12.0)
        n_fft_new = int(round(self.n_fft * factor))
        win_size_new = int(round(self.win_size * factor))
        hop_new = int(round(self.hop_length * speed))

        pad_left = (win_size_new - hop_new) // 2
        pad_right = max((win_size_new - hop_new + 1) // 2, win_size_new - y.shape[-1] - pad_left)
        mode = "reflect" if pad_right < y.shape[-1] else "constant"
        y = _pad_last(y, pad_left, pad_right, mode)

        window = hann_window(win_size_new, device=y.device)
        spec = stft(y, n_fft_new, hop_new, win_length=win_size_new, window=window, center=False)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        if keyshift != 0:
            size = self.n_fft // 2 + 1
            if mag.shape[-2] < size:
                mag = F.pad(mag, (0, 0, 0, size - mag.shape[-2]))
            mag = mag[..., :size, :] * (self.win_size / win_size_new)
        mel = torch.einsum("mf,...ft->...mt", self.mel_basis.to(y.device), mag)
        return torch.log(mel.clamp(min=self.clip_val))

    def frames_for_length(self, n_samples: int, speed: float = 1.0) -> int:
        hop_new = int(round(self.hop_length * speed))
        pad_left = (self.win_size - hop_new) // 2
        pad_right = max((self.win_size - hop_new + 1) // 2, self.win_size - n_samples - pad_left)
        return 1 + (n_samples + pad_left + pad_right - self.win_size) // hop_new


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
