"""Frozen Euclidean codebook (nearest-centroid snap and centroid lookup).

Counterpart of `latent_diffusion_speech_tpu/quantize/codebook.py::EuclideanCodebook`.
`dequantize` is on the serve path (semantic token -> unit embedding);
`quantize` is the plain version of the K6 argmin kernel, which is still to be
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device

__all__ = ["EuclideanCodebook"]


class EuclideanCodebook:
    """Nearest-centroid quantizer around a (K, D) codebook."""

    def __init__(self, codebook, device=None):
        """device: None means `cuda` (raises without a card)."""
        self.codebook = torch.as_tensor(np.asarray(codebook, np.float32), device=resolve_device(device))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> ids (...,): argmax of 2 x.e - |e|^2."""
        flat = x.reshape(-1, x.shape[-1]).float()
        e = self.codebook
        scores = 2.0 * flat @ e.T - (e * e).sum(dim=-1)[None, :]
        return scores.argmax(dim=-1).reshape(x.shape[:-1])

    def dequantize(self, ids: torch.Tensor) -> torch.Tensor:
        return self.codebook[torch.as_tensor(ids, device=self.codebook.device).long()]
