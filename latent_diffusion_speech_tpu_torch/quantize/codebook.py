"""Frozen Euclidean codebook (nearest-centroid snap and centroid lookup).

Counterpart of `latent_diffusion_speech_tpu/quantize/codebook.py::EuclideanCodebook`.
`dequantize` is on the serve path (semantic token -> unit embedding);
`quantize` is the diffusion trainer's k-means snap, through the K6 wrapper
(`ops/kernels/kmeans.py`): the CUDA kernel for a codebook on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.ops.kernels.kmeans import kmeans_argmin
from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device

__all__ = ["EuclideanCodebook"]


class EuclideanCodebook:
    """Nearest-centroid quantizer around a (K, D) codebook."""

    def __init__(self, codebook, device=None):
        """device: None means `cuda` (raises without a card)."""
        self.codebook = torch.as_tensor(np.asarray(codebook, np.float32), device=resolve_device(device))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> int32 ids (...,): the nearest centroid, i.e. the
        argmax of 2 x.e - |e|^2 (argmin of |e|^2 - 2 x.e), ties to the
        lowest id."""
        flat = x.reshape(-1, x.shape[-1]).float()
        return kmeans_argmin(flat, self.codebook).reshape(x.shape[:-1])

    def dequantize(self, ids: torch.Tensor) -> torch.Tensor:
        return self.codebook[torch.as_tensor(ids, device=self.codebook.device).long()]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Snap x to its nearest centroids (a lookup: no gradient path)."""
        with torch.no_grad():
            return self.dequantize(self.quantize(x))
