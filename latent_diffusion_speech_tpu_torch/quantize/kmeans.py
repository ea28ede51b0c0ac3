"""Loading a k-means codebook.

Counterpart of `latent_diffusion_speech_tpu/quantize/kmeans.py::load_codebook`.
K-means fitting and prediction over a corpus (the preprocessing stage) are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["load_codebook"]


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
