"""K-means prediction and codebook loading.

Counterpart of `latent_diffusion_speech_tpu/quantize/kmeans.py`
(`kmeans_predict`, `load_codebook`).  Prediction is the nearest-centroid
argmin that JAX's `_predict` computes with XLA: on the card it is one K6
launch (`ops/kernels/kmeans.py::kmeans_argmin`), on the CPU the plain
version.  Fitting (`kmeans_fit`, `kmeanspp_init`, stage 18) is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.ops.kernels.kmeans import kmeans_argmin

__all__ = ["kmeans_predict", "load_codebook"]


def kmeans_predict(x, centroids) -> torch.Tensor:
    """Nearest-centroid token ids (...,) int32 for x (..., D), in f32, on
    the centroids' device (a numpy codebook means the CPU): K6 on the card."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=centroids.device)
    return kmeans_argmin(x.reshape(-1, x.shape[-1]), centroids).reshape(x.shape[:-1])


def load_codebook(path: str | Path) -> np.ndarray:
    """Centroids (K, D) f32 from this framework's `.npz` (`cluster_centers_`)
    or the reference's torch dict (`semantic_codebook.pt`, sklearn attribute
    names)."""
    path = Path(path)
    if path.suffix in (".pt", ".pth"):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "cluster_centers_" in obj:
            c = obj["cluster_centers_"]
        elif hasattr(obj, "cluster_centers_"):
            c = obj.cluster_centers_
        else:
            raise ValueError(f"{path}: unrecognized codebook checkpoint layout")
        c = c.detach().cpu().numpy() if hasattr(c, "detach") else np.asarray(c)
        return np.asarray(c, np.float32)
    with np.load(path) as f:
        return np.asarray(f["cluster_centers_"], np.float32)
