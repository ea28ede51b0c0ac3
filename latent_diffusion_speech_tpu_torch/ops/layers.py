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

__all__ = ["Dense", "LayerNorm", "GroupNorm", "cast_compute_dtype", "init_weights", "seeded", "no_tf32",
           "resolve_device"]


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


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, conv_std: float | None = None) -> nn.Module:
    """The flax initialisers the JAX modules are seeded with, drawn on the
    module's device from `generator`: products (`nn.Linear`, `nn.Conv1d`)
    LeCun-normal truncated at two standard deviations (flax's `nn.Dense`
    default and the JAX UNets' explicit `lecun_normal()`), embeddings
    N(0, 1/C) (flax's `default_embed_init`: variance scaling 1.0 over
    fan-in C, a plain normal), biases 0, norm scales 1 and offsets 0.
    `conv_std` draws every `nn.Conv1d` and `nn.ConvTranspose1d` from
    N(0, conv_std) instead, as the HiFi-VAEGAN modules do (0.01)."""
    for m in module.modules():
        if conv_std is not None and isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.normal_(0.0, conv_std, generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978  # flax's truncated_normal correction
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)) and m.weight is not None:
            m.weight.fill_(1.0)
        elif isinstance(m, nn.ConvTranspose1d):
            raise ValueError("init_weights: a transposed convolution needs conv_std (flax has no default for it)")
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    return module


def seeded(factory, seed: int) -> nn.Module:
    """Build modules with `factory` and draw their weights with
    `init_weights` from a CPU generator seeded with `seed` (the caller's
    global RNG state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        module = factory()
    return init_weights(module, torch.Generator().manual_seed(seed))


def no_tf32() -> None:
    """Full f32 products and convolutions on the card, as the JAX package
    computes in f32: TF32 would round their inputs to 10 mantissa bits.
    The switches are process-wide and stay off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
