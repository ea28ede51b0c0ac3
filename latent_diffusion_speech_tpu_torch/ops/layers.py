"""Layers with the JAX package's mixed-precision conventions.

The JAX modules keep f32 parameters and cast the matmul and conv weights to
the compute dtype at each call, while normalisations compute in f32 with f32
parameters and the caller casts their output.  Here the modules are built in
f32 and `cast_compute_dtype` casts the weights of every `Dense`, `nn.Conv1d`
and `nn.ConvTranspose1d` to the compute dtype once; norms and embeddings stay
f32.  Each layer casts its input to its weight's dtype, so torch's type
promotion then follows JAX's (bf16 + f32 -> f32, ...).

Training in bf16 keeps the f32 weights, as flax's `dtype` does:
`set_compute_dtype` makes every `ComputeDtype` layer (`Dense` and the
UNet's convolutions) cast its weight and bias to the compute dtype at each
call, so the products run in bf16 and the gradients reach the f32 weights
through the casts.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

__all__ = ["ComputeDtype", "Dense", "dense_product", "keep_split", "local_heads", "LayerNorm", "GroupNorm", "cast_compute_dtype", "set_compute_dtype",
           "init_weights", "seeded", "built_for_init", "no_tf32", "resolve_device"]


class ComputeDtype:
    """Mixin for a product layer with `weight` and `bias`: the dtype it
    computes in is its weight's, unless `set_compute_dtype` set another.
    `split`, set by `parallel/sharding.py::apply_param_shardings` when the
    weight is split over a mesh axis, is how the product is partitioned
    (`parallel/tensor.py::Split`); None: the weight is whole."""

    _compute_dtype = None
    split = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.weight.dtype if self._compute_dtype is None else self._compute_dtype

    def cast_weights(self):
        """(weight, bias) in the compute dtype (differentiable casts)."""
        dtype = self._compute_dtype
        if dtype is None:  # the serve path: no cast a call
            return self.weight, self.bias
        return self.weight.to(dtype), None if self.bias is None else self.bias.to(dtype)


class Dense(ComputeDtype, nn.Linear):
    """nn.Linear that casts its input, weight and bias to its compute dtype
    (flax nn.Dense with `dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.cast_weights()
        if self.split is not None:
            return self.split.linear(x, weight, bias, dense_product)
        return dense_product(x, weight, bias)


def dense_product(x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """x in the weight's dtype times the weight, plus the bias (the product
    of `Dense` and the UNet's GEGLU projection)."""
    return F.linear(x.to(weight.dtype), weight, bias)


def keep_split(columns, row, heads: int = 1) -> bool:
    """Under tensor parallelism: when every layer of `columns` is
    column-parallel (its bias absent or split with it), `row` is
    row-parallel over the same ranks and each chunk holds whole heads (of
    `heads` over the features), let the columns' outputs stay split (their
    `Split.local`) and return True: the row layer then takes this rank's
    features and sums the partial products.  False leaves every layer as it
    is (each output gathered whole)."""
    splits = [c.split for c in columns]
    if row.split is None or row.split.mode != "row" or any(s is None or s.mode != "column" for s in splits):
        return False
    size = row.split.size
    if any(s.size != size or s.index != row.split.index for s in splits) or heads % size:
        return False
    if any(c.bias is not None and not c.split.bias_split for c in columns):
        return False
    for s in splits:
        s.local = True
    return True


def local_heads(n_heads: int, columns, row) -> int:
    """The heads this rank runs: its share of `n_heads` when `keep_split`
    lets q, k and v stay split, else all of them."""
    return n_heads // row.split.size if keep_split(columns, row, n_heads) else n_heads


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


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Compute every `ComputeDtype` layer of `module` in `dtype` from its
    own (f32) weights; None computes in the weights' dtype again."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m._compute_dtype = dtype
    return module


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, conv_std: float | None = None) -> nn.Module:
    """The flax initialisers the JAX modules are seeded with, drawn on the
    module's device from `generator`: products (`nn.Linear`, `nn.Conv1d`,
    `nn.Conv2d`) LeCun-normal truncated at two standard deviations over a
    fan-in of in / groups x the kernel's taps (flax's `nn.Dense` and
    `nn.Conv` default and the JAX UNets' explicit `lecun_normal()`), embeddings
    N(0, 1/C) (flax's `default_embed_init`: variance scaling 1.0 over
    fan-in C, a plain normal), biases 0, norm scales 1 and offsets 0.
    `conv_std` draws every `nn.Conv1d` and `nn.ConvTranspose1d` from
    N(0, conv_std) instead, as the HiFi-VAEGAN modules do (0.01).  A module
    with an `init_flax(generator)` method draws its own parameters."""
    for m in module.modules():
        if hasattr(m, "init_flax"):  # a module with parameters of its own kind (ops/moe.py)
            m.init_flax(generator)
            continue
        if conv_std is not None and isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.normal_(0.0, conv_std, generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
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


class _NoDefaultInit(TorchFunctionMode):
    """Skips torch's own draws in the constructors of the layers that
    `init_weights` draws anew: `nn.Linear`, the convolutions and
    `nn.Embedding` call only these three initialisers in
    `reset_parameters`, and nothing else in the package calls them."""

    SKIPPED = (nn.init.kaiming_uniform_, nn.init.uniform_, nn.init.normal_)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.SKIPPED:
            return args[0] if args else kwargs["tensor"]
        return func(*args, **kwargs)


@contextlib.contextmanager
def built_for_init():
    """Build modules whose weights `init_weights` draws next: torch's
    default draws of their products and embeddings are skipped (their
    tensors hold whatever was allocated until `init_weights` fills them),
    and the caller's global RNG state is left as it was.  Only for modules
    that `init_weights` then covers whole: the same weights, less start-up."""
    with torch.random.fork_rng(devices=[]), _NoDefaultInit():
        yield


def seeded(factory, seed: int) -> nn.Module:
    """Build modules with `factory` and draw their weights with
    `init_weights` from a CPU generator seeded with `seed` (the caller's
    global RNG state is left as it was)."""
    with built_for_init():
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
