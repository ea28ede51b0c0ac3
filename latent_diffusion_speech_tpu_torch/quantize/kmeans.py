"""K-means: the minibatch fit, prediction and codebook files.

Counterpart of `latent_diffusion_speech_tpu/quantize/kmeans.py`
(`kmeanspp_init`, `kmeans_fit`, `kmeans_predict`, `save_codebook`,
`load_codebook`).  The nearest-centroid argmin that JAX computes with XLA
(`_predict`, and the assignment of `_assign_update`) is
`ops/kernels/kmeans.py::kmeans_argmin`: one K6 launch on the card, the
plain version on the CPU.  The fit is stage 17's (`cli/preprocess_cluster.py`):
k-means++ seeds on a subsample, then JAX's minibatch schedule and EMA
update (the reference's `KMeansGPU`, lr = 1 / count per centroid).  Its
centroid sums are the one-hot product JAX computes, so two fits with one
seed give the same codebook bit for bit on the card (no atomics); the
product runs at the process's f32 matmul precision, so the stage's `main`
turns TF32 off.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.ops.kernels.kmeans import kmeans_argmin
from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device

__all__ = ["kmeanspp_init", "kmeans_fit", "kmeans_predict", "save_codebook", "load_codebook"]


def kmeanspp_init(data: np.ndarray, k: int, seed: int = 0, sample: int = 65536, device=None) -> torch.Tensor:
    """k-means++ seeds (k, D) f32 on `device` (None: `cuda`), drawn from a
    subsample of at most `sample` rows (numpy's `default_rng(seed)`, as
    JAX).  Each seed is a row of the data drawn with probability
    proportional to its squared distance to the nearest seed so far
    (`torch.multinomial` from a generator seeded with `seed`; JAX draws
    with `jax.random`, so the two packages pick other rows)."""
    rng = np.random.default_rng(seed)
    if data.shape[0] > sample:
        data = data[rng.choice(data.shape[0], sample, replace=False)]
    x = torch.as_tensor(np.asarray(data, np.float32), device=resolve_device(device))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    first = torch.randint(x.shape[0], (1,), generator=gen, device=x.device)
    centroids = torch.empty((k, x.shape[1]), dtype=torch.float32, device=x.device)
    centroids[0] = x[first[0]]
    min_d = ((x - centroids[0]) ** 2).sum(-1)
    for i in range(1, k):
        c = x[torch.multinomial(min_d, 1, generator=gen)[0]]
        centroids[i] = c
        min_d = torch.minimum(min_d, ((x - c) ** 2).sum(-1))
    return centroids


def _assign_update(centroids: torch.Tensor, counts: torch.Tensor, batch: torch.Tensor):
    """One minibatch step: nearest assignment (K6 on the card) and the EMA
    update, lr = batch count / new count per centroid.  Returns (new
    centroids, new counts, the batch's summed squared distance to its
    assigned centroids)."""
    ids = kmeans_argmin(batch, centroids).long()
    k = centroids.shape[0]
    batch_counts = torch.bincount(ids, minlength=k).to(torch.float32)
    onehot = torch.nn.functional.one_hot(ids, k).to(torch.float32)
    batch_sums = onehot.T @ batch
    new_counts = counts + batch_counts
    lr = torch.where(batch_counts > 0, batch_counts / new_counts.clamp(min=1.0), 0.0)
    batch_means = batch_sums / batch_counts.clamp(min=1.0)[:, None]
    inertia = ((batch - centroids[ids]) ** 2).sum()
    return centroids + lr[:, None] * (batch_means - centroids), new_counts, inertia


def kmeans_fit(
    data: np.ndarray,
    k: int = 4096,
    epochs: int = 4,
    batch_size: int = 8192,
    seed: int = 0,
    init: Optional[np.ndarray] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Minibatch EMA k-means on `device` (None: `cuda`). Returns (centroids
    (k, D) f32, the last epoch's inertia per point).  JAX's schedule: a
    numpy permutation an epoch, `max(1, n // batch_size)` batches, a short
    last batch filled from the permutation's start."""
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    device = resolve_device(device)
    if init is None:
        centroids = kmeanspp_init(data, k, seed=seed, device=device)
    else:
        centroids = torch.tensor(np.asarray(init, np.float32), device=device)
    counts = torch.zeros((centroids.shape[0],), dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    n_batches = max(1, n // batch_size)
    inertia = 0.0
    for epoch in range(epochs):
        perm = rng.permutation(n)
        total, t0 = 0.0, time.perf_counter()
        for b in range(n_batches):
            idx = perm[b * batch_size: (b + 1) * batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, perm[: batch_size - len(idx)]])
            batch = torch.from_numpy(data[idx]).to(device)
            centroids, counts, bi = _assign_update(centroids, counts, batch)
            total += float(bi)
        inertia = total / (n_batches * batch_size)
        if verbose:
            ms = (time.perf_counter() - t0) * 1e3 / n_batches
            print(f"kmeans epoch {epoch}: inertia/point = {inertia:.4f} ({ms:.2f} ms a step)")
    return centroids.cpu().numpy(), inertia


def kmeans_predict(x, centroids) -> torch.Tensor:
    """Nearest-centroid token ids (...,) int32 for x (..., D), in f32, on
    the centroids' device (a numpy codebook means the CPU): K6 on the card."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=centroids.device)
    return kmeans_argmin(x.reshape(-1, x.shape[-1]), centroids).reshape(x.shape[:-1])


def save_codebook(path: str | Path, centroids: np.ndarray) -> None:
    """Centroids to this framework's npz (`cluster_centers_`; numpy adds
    `.npz` to a path without it, as in JAX)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, cluster_centers_=np.asarray(centroids, np.float32))


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
