"""Layers with the JAX package's mixed-precision conventions.

The JAX modules keep f32 parameters and cast the matmul and conv weights to
the compute dtype at each call, while normalisations compute in f32 with f32
parameters and the caller casts their output.  Here the modules are built in
f32 and `cast_compute_dtype` casts the weights of every `Dense`, `nn.Conv1d`
and `nn.ConvTranspose1d` to the compute dtype once; norms and embeddings stay
f32.  Each layer casts its input to its weight's dtype, so torch's type
promotion then follows JAX's (bf16 + f32 -> f32, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "LayerNorm", "GroupNorm", "cast_compute_dtype", "seeded", "resolve_device"]


class Dense(nn.Linear):
    """nn.Linear that casts its input to the weight dtype (flax nn.Dense
    with `dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in f32; returns f32 (flax nn.LayerNorm
    with f32 params).  flax's default epsilon is 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels-last (B, T, C) in f32; returns f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups, self.weight, self.bias, self.eps)
        return y.transpose(1, 2)


def cast_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast matmul/conv weights (not norms or embeddings) to `dtype`."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            m.to(dtype)
    return module


def seeded(factory, seed: int):
    """Build modules under a private RNG seeded with `seed` (the caller's
    global RNG state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return factory()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the card (`cuda`).

    Asking for `cuda` without a CUDA device raises; the CPU is used only when
    the caller asks for it (`device="cpu"`)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the default) but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
