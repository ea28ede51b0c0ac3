"""Codebooks: the frozen Euclidean snap and the learned cosine VQ.

Counterpart of `latent_diffusion_speech_tpu/quantize/codebook.py`.
* `EuclideanCodebook`: `dequantize` is on the serve path (semantic token ->
  unit embedding); `quantize` is the diffusion trainer's k-means snap,
  through the K6 wrapper (`ops/kernels/kmeans.py`): the CUDA kernel for a
  codebook on the card, its plain version on the CPU.
* `VectorQuantize` over an explicit `VQState`: a projection of the input to
  `codebook_dim`, cosine similarity against L2-normalised codes (ties to the
  lowest id, as `jnp.argmax`), a straight-through estimator in the projected
  space, the commitment loss, and an EMA codebook (decay 0.8).  The state is
  plain tensors, not parameters: the projections never train (the JAX loss
  differentiates only the model's parameters) and the codebook moves by EMA
  alone.  `convert.vq_state_from_jax` carries a JAX `VQState` across.  The
  cosine argmax is a plain product, as in the JAX package (no Pallas
  kernel); the EMA's per-code sums are a one-hot product, so a step on the
  card repeats bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.ops.kernels.kmeans import kmeans_argmin
from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device

__all__ = ["EuclideanCodebook", "VectorQuantize", "VQState"]


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


class VQState(NamedTuple):
    """The learned VQ's state (no gradients)."""

    codebook: torch.Tensor    # (K, d_code), L2-normalised rows
    ema_counts: torch.Tensor  # (K,)
    proj_in: torch.Tensor     # (D, d_code)
    proj_out: torch.Tensor    # (d_code, D)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class VectorQuantize:
    def __init__(
        self,
        dim: int,
        codebook_size: int = 4096,
        codebook_dim: int = 32,
        decay: float = 0.8,
        commitment_weight: float = 1.0,
    ):
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.decay = decay
        self.commitment_weight = commitment_weight

    def init(self, generator: torch.Generator, device=None) -> VQState:
        """A fresh state drawn from a CPU `generator`, as the JAX `init`
        draws it (normalised normal codes, zero counts, uniform
        projections within 1/sqrt(fan-in)), on `device` (None: the CPU)."""
        scale_in, scale_out = self.dim ** -0.5, self.codebook_dim ** -0.5
        codebook = _l2norm(torch.randn((self.codebook_size, self.codebook_dim), generator=generator))
        proj_in = torch.rand((self.dim, self.codebook_dim), generator=generator) * (2 * scale_in) - scale_in
        proj_out = torch.rand((self.codebook_dim, self.dim), generator=generator) * (2 * scale_out) - scale_out
        state = VQState(codebook, torch.zeros(self.codebook_size), proj_in, proj_out)
        return VQState(*(t.to(device) for t in state)) if device is not None else state

    def encode(self, state: VQState, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> ids by cosine similarity in the projected space."""
        z = _l2norm(x.reshape(-1, self.dim).float() @ state.proj_in)
        return torch.argmax(z @ state.codebook.T, dim=-1).reshape(x.shape[:-1])

    def decode(self, state: VQState, ids: torch.Tensor) -> torch.Tensor:
        return state.codebook[ids.long()] @ state.proj_out

    def __call__(
        self, state: VQState, x: torch.Tensor, train: bool = True
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
        """Quantize with the straight-through estimator: (quantized (..., D),
        ids (...), commitment loss, new state).  The gradient reaches `x`
        through the projection (straight through the snap, and through the
        commitment loss); with `train` the codebook and counts take one EMA
        step from this batch."""
        flat = x.reshape(-1, self.dim).float()
        z = flat @ state.proj_in
        zn = _l2norm(z)
        ids = torch.argmax(zn @ state.codebook.T, dim=-1)
        codes = state.codebook[ids]
        commit = ((zn - codes) ** 2).sum(dim=-1).mean()
        q = z + (codes - z).detach()
        out = (q @ state.proj_out).reshape(x.shape)
        if train:
            with torch.no_grad():
                onehot = torch.nn.functional.one_hot(ids, self.codebook_size).float()
                counts = onehot.sum(dim=0)
                sums = onehot.T @ zn
                new_counts = state.ema_counts * self.decay + counts * (1 - self.decay)
                means = sums / counts.clamp_min(1.0)[:, None]
                updated = torch.where((counts > 0)[:, None],
                                      _l2norm(state.codebook * self.decay + means * (1 - self.decay)), state.codebook)
            state = state._replace(codebook=updated, ema_counts=new_counts)
        return out, ids.reshape(x.shape[:-1]), self.commitment_weight * commit, state

    def utilization(self, state: VQState, thresh: float = 1e-3) -> torch.Tensor:
        """The share of codes with recent use (EMA count above `thresh`)."""
        return (state.ema_counts > thresh).float().mean()
