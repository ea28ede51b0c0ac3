"""Frame-RMS volume and the voiced mask.

Counterpart of `latent_diffusion_speech_tpu/ops/volume.py` (the reference's
`Volume_Extractor`, `tools/tools.py:12-41`): the frame mean of x^2 over
reflect-padded audio, square-rooted; the mask is a dB threshold, a 9-tap
running max with edge padding, then linear upsampling to the sample rate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.ops.stft import _pad_last

__all__ = ["extract_volume", "get_volume_mask", "upsample_frames"]


def extract_volume(audio: torch.Tensor, hop_size: int = 512) -> torch.Tensor:
    """Input (..., T); output (..., T // hop + 1) frame RMS."""
    n_frames = audio.shape[-1] // hop_size + 1
    audio2 = _pad_last(audio**2, hop_size // 2, (hop_size + 1) // 2, "reflect")
    frames = audio2[..., : n_frames * hop_size].reshape(audio.shape[:-1] + (n_frames, hop_size))
    return frames.mean(-1).sqrt()


def upsample_frames(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """Frame-rate -> sample-rate linear upsampling (reference
    `tools/tools.py:225-229`): append the last frame, align-corners linear
    interpolation to T * factor + 1 points, drop the last.
    Input (B, T, C); output (B, T * factor, C)."""
    T = signal.shape[1]
    x = torch.cat([signal, signal[:, -1:]], dim=1)
    out_len = T * factor + 1
    pos = torch.arange(out_len - 1, dtype=torch.float32, device=signal.device) * (T / (out_len - 1))
    i0 = pos.floor().long()
    i1 = (i0 + 1).clamp(max=T)
    w = (pos - i0)[None, :, None]
    return x[:, i0] * (1 - w) + x[:, i1] * w


def get_volume_mask(volume: torch.Tensor, block_size: int = 512, threshold_db: float = -60.0) -> torch.Tensor:
    """Voiced mask at the sample rate from frame volume (reference
    `tools/tools.py:35-41`). Input (T_frames,) or (B, T_frames); output
    (B, T_frames * block_size)."""
    if volume.dim() == 1:
        volume = volume[None]
    mask = (volume > 10.0 ** (threshold_db / 20.0)).float()
    padded = torch.cat([mask[:, :1].expand(-1, 4), mask, mask[:, -1:].expand(-1, 4)], dim=1)
    mask = F.max_pool1d(padded[:, None], 9, stride=1)[:, 0]  # the 9-tap running max
    return upsample_frames(mask[:, :, None], block_size)[..., 0]
