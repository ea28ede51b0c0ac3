"""The partitioned products of tensor and expert parallelism.

The JAX package lays parameters out over the mesh (`parallel/sharding.py`)
and XLA's SPMD partitioner inserts the collectives.  Here each rank holds
its chunk of a split parameter (`parallel/sharding.py::apply_param_shardings`)
and the layer that owns it runs Megatron's partitioned product with the
collectives below, every one of them differentiable:

* `copy_to` (Megatron's "f"): the identity, whose backward sums the
  gradient over the group: the input of a product whose output features are
  split (column-parallel) gets a partial gradient on each rank;
* `reduce_from` ("g"): the sum over the group, whose backward is the
  identity: the partial sums of a product whose input features are split
  (row-parallel);
* `gather_from`: the concatenation of the ranks' chunks along a dimension,
  whose backward keeps this rank's chunk of the gradient;
* `scatter_to`: this rank's chunk along a dimension, whose backward gathers;
* `gather_summed`: the concatenation of the ranks' chunks, whose backward
  sums the gradient over the group and keeps this rank's chunk: for a
  whole that each rank uses differently (its own rows of queries against
  every key, under sequence parallelism).

`Split` is what a product layer (`ops/layers.py::Dense`, the UNet's
`Conv1dSame` and `GegluFF`) knows of its split weight, and `Split.linear`
runs it:
* output features split (`column`): the rank computes its features; they
  are gathered along the last dimension (before the GroupNorm that follows
  a convolution, before the GEGLU's split into value and gate halves)
  unless the owning module asked for them as they are (`local`: the
  attention's local heads, a feed-forward whose partner is row-parallel).
  A bias that stayed replicated is added after the gather, so its
  gradient is whole on every rank;
* input features split (`row`): an input that holds every feature is cut
  to this rank's (`scatter_to`), one that holds this rank's is taken as it
  is; the partial products are summed over the group and the bias added
  once;
* any other split (a convolution's taps): the weight is gathered whole
  before the product.

Every rank of a group computes the same values after each collective (one
all-reduce gives every rank the same sums), so the replicated parameters
get the same gradients on every rank and stay equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["Split", "copy_to", "reduce_from", "gather_from", "gather_summed", "scatter_to", "chunk_of"]


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out, dim=dim)


def chunk_of(x: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    """Chunk `index` of `size` equal contiguous chunks of `x` along `dim`."""
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return chunk_of(grad, ctx.dim, dist.get_rank(ctx.group), dist.get_world_size(ctx.group)).contiguous(), \
            None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return chunk_of(grad, ctx.dim, dist.get_rank(ctx.group), dist.get_world_size(ctx.group)).contiguous(), \
            None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk_of(x, dim, dist.get_rank(group), dist.get_world_size(group)).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_cat(grad, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim % x.dim())


def gather_summed(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherSummed.apply(x, group, dim % x.dim())


def scatter_to(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _ScatterTo.apply(x, group, dim % x.dim())


@dataclasses.dataclass
class Split:
    """A product layer's split weight: `spec` (one mesh axis or None a
    weight dimension, torch layout), the process group over its axes, the
    group's `size` and this rank's `index` in it, whether the bias is split
    with the output features, and `local` (column-parallel: leave the output
    as this rank's features)."""

    spec: tuple
    group: Any
    size: int
    index: int
    bias_split: bool = False
    local: bool = False

    @property
    def mode(self) -> str:
        split = [d for d, a in enumerate(self.spec) if a is not None]
        if split == [0]:
            return "column"
        if split == [1]:
            return "row"
        return "gather"

    def whole_weight(self, weight: torch.Tensor) -> torch.Tensor:
        """The weight gathered whole (the `gather` mode)."""
        for d, a in enumerate(self.spec):
            if a is not None:
                weight = gather_from(weight, self.group, d)
        return weight

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], product) -> torch.Tensor:
        """`product(x, weight, bias)` (channels last, features in the last
        dimension) with this split: see the module's docstring."""
        mode = self.mode
        if mode == "column":
            y = product(copy_to(x, self.group), weight, bias if self.bias_split else None)
            if self.local:  # the owner checked: no bias, or one split with the features
                return y
            y = gather_from(y, self.group, -1)
            return y if bias is None or self.bias_split else y + bias
        if mode == "row":
            local_in = weight.shape[1]
            if x.shape[-1] != local_in:
                x = scatter_to(x, self.group, -1)
            y = reduce_from(product(x, weight, None), self.group)
            return y if bias is None else y + bias
        return product(x, self.whole_weight(weight), bias)
