"""Declarative parameter sharding: tensor and expert parallelism.

Counterpart of `latent_diffusion_speech_tpu/parallel/sharding.py`.  The
rules are the JAX package's, (path regex, PartitionSpec) pairs matched
against each parameter's flax path ("a/b/kernel") with the spec over the
flax layout: qkv, FF-in and GEGLU column-parallel, attention-out and FF-out
row-parallel over `model`, conv kernels' output channels over `model`, the
biases of column-parallel layers with their outputs, and the MoE banks
(E, C, F) / (E, F, C) over `expert` and `model`.  A port parameter is
matched through its flax view (`flax_view`): the port names its modules
after the flax tree, a product layer's `weight` is flax's `kernel` with the
dimensions reversed (a `Linear`'s (out, in) is flax's (in, out), a
convolution's (out, in, k) flax's (k, in, out)), a norm's `weight` its
`scale`, an embedding's its `embedding`; other leaves keep name and layout.
So JAX's regex quirks carry over as they are: `(out|to_out|o_proj)/kernel$`
also matches `proj_out`, `ff_out` and `conv_out` (a conv kernel's first
flax dimension, its taps, which the `model` axis seldom divides).

JAX's policy (`infer_param_shardings`): a rule applies only where the mesh
axes divide the dimensions it splits; axes of size 1 are dropped (so one
rule set serves tensor-only, expert-only and combined meshes); anything
unmatched is replicated.  A spec here is a tuple over the port parameter's
dimensions, a mesh axis or None each.

`apply_param_shardings` replaces each split parameter by this rank's
contiguous chunk (for every device coordinate, the shard JAX's
`NamedSharding` gives that device) and tells the layer that owns it how to
run (`parallel/tensor.py::Split`; the MoE banks' `MoEMLP.split`); modules
with a `plan_tensor_parallel()` method then choose where the features may
stay split between two layers (local heads, a feed-forward's hidden).
`gather_full_state` is the inverse, a collective over the ranks.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from latent_diffusion_speech_tpu_torch.parallel.mesh import AXES, Mesh
from latent_diffusion_speech_tpu_torch.parallel.tensor import Split, chunk_of, gather_from

__all__ = ["ShardingRules", "DEFAULT_TP_RULES", "infer_param_shardings", "apply_param_shardings",
           "flax_view", "local_chunk", "global_shape", "split_axes", "gather_full_state", "is_split", "local_state",
           "shard_module"]

Spec = Tuple[Optional[str], ...]
ShardingRules = Sequence[Tuple[str, Spec]]

# path regexes are matched against "a/b/c"-joined flax paths, specs over flax layouts
DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    # attention projections: qkv column-parallel, out row-parallel
    (r"(query|key|value|to_q|to_k|to_v|q_proj|k_proj|v_proj)/kernel$", (None, "model")),
    (r"(out|to_out|o_proj)/kernel$", ("model", None)),
    # feed-forward: in/gate column-parallel, out row-parallel
    (r"(ff_in|ff_proj|mlp_0|gate_proj|up_proj)/kernel$", (None, "model")),
    (r"(ff_out|mlp_2|down_proj)/kernel$", ("model", None)),
    # conv kernels (k, in, out): shard output channels
    (r"(conv1|conv2|conv_in)/.*kernel$", (None, None, "model")),
    # biases of column-parallel layers follow their outputs
    (r"(query|key|value|to_q|to_k|to_v|ff_in|ff_proj|mlp_0)/bias$", ("model",)),
    # MoE expert banks (E, C, F)/(E, F, C): expert dim over 'expert', hidden
    # dim over 'model'; the router gate stays replicated
    (r"moe/w_(gate|up)$", ("expert", None, "model")),
    (r"moe/w_down$", ("expert", "model", None)),
]

_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d)
_NORMS = (nn.LayerNorm, nn.GroupNorm)


def flax_view(module: nn.Module, leaf: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(the flax leaf name, `perm`) of `module`'s parameter `leaf`: flax
    dimension i is port dimension perm[i]."""
    ident = tuple(range(ndim))
    if leaf == "weight":
        if isinstance(module, _KERNEL_MODULES) and ndim in (2, 3):
            return "kernel", tuple(reversed(ident))
        if isinstance(module, _KERNEL_MODULES) and ndim == 4:  # (out, in, kh, kw) <- (kh, kw, in, out)
            return "kernel", (2, 3, 1, 0)
        if isinstance(module, nn.Embedding):
            return "embedding", ident
        if isinstance(module, _NORMS) or ndim == 1:
            return "scale", ident
    return leaf, ident


def _named_leaves(module: nn.Module):
    for mname, m in module.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            yield (f"{mname}.{leaf}" if mname else leaf), mname, m, leaf, p


def infer_param_shardings(module: nn.Module, mesh: Mesh, rules: ShardingRules = DEFAULT_TP_RULES
                          ) -> Dict[str, Spec]:
    """{parameter name: spec over its dimensions} for every parameter of
    `module` (all None: replicated), by JAX's rules and policy."""
    shape = mesh.shape
    out = {}
    for name, mname, m, leaf, p in _named_leaves(module):
        fleaf, perm = flax_view(m, leaf, p.ndim)
        path = "/".join([*mname.split("."), fleaf] if mname else [fleaf])
        fshape = [p.shape[d] for d in perm]
        spec: Spec = (None,) * p.ndim
        for pattern, rule in rules:
            if not (re.search(pattern, path) and len(rule) <= p.ndim):
                continue
            eff = [a if (a is None or shape.get(a, 1) > 1) else None for a in rule]
            if all(a is None for a in eff):
                continue
            if any(a is not None and fshape[d] % shape[a] != 0 for d, a in enumerate(eff)):
                continue
            full = eff + [None] * (p.ndim - len(eff))
            port = [None] * p.ndim
            for fd, a in enumerate(full):
                port[perm[fd]] = a
            spec = tuple(port)
            break
        out[name] = spec
    return out


def is_split(spec: Spec) -> bool:
    return any(a is not None for a in spec)


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits, in `AXES` order."""
    return tuple(a for a in AXES if a in spec)


def local_chunk(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of the global tensor `full` under `spec`."""
    for d, a in enumerate(spec):
        if a is not None:
            full = chunk_of(full, d, mesh.coordinate(a), mesh.axis_size(a))
    return full


def local_state(state: Dict[str, torch.Tensor], shardings: Dict[str, Spec], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's chunks (a single-file
    checkpoint restored onto a split layout)."""
    return {n: local_chunk(t, shardings[n], mesh) if n in shardings else t for n, t in state.items()}


def global_shape(local: Sequence[int], spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(n * (mesh.axis_size(a) if a is not None else 1) for n, a in zip(local, spec))


def _split_for(spec: Spec, mesh: Mesh) -> Split:
    axes = split_axes(spec)
    if len(axes) != 1:
        raise NotImplementedError(f"a product layer's weight split over {axes}: one mesh axis is supported")
    return Split(spec, mesh.axis_group(axes), mesh.axis_size(axes[0]), mesh.coordinate(axes[0]))


@torch.no_grad()
def apply_param_shardings(module: nn.Module, shardings: Dict[str, Spec], mesh: Mesh) -> nn.Module:
    """Keep this rank's chunk of every split parameter of `module` (in
    place: the same `Parameter` objects, their data replaced) and set up the
    layers that own them; then every module's `plan_tensor_parallel()`."""
    from latent_diffusion_speech_tpu_torch.ops.layers import ComputeDtype
    from latent_diffusion_speech_tpu_torch.ops.moe import MoEMLP

    for name, mname, m, leaf, p in list(_named_leaves(module)):
        spec = shardings.get(name, (None,) * p.ndim)
        if not is_split(spec):
            continue
        p.data = local_chunk(p.data, spec, mesh).clone()
        if isinstance(m, MoEMLP):
            m.split[leaf] = spec
        elif isinstance(m, ComputeDtype) and leaf == "weight":
            m.split = _split_for(spec, mesh)
        elif isinstance(m, ComputeDtype) and leaf == "bias":
            pass  # checked below, with its weight
        else:
            raise NotImplementedError(f"{name}: a split parameter of a {type(m).__name__}, which runs no "
                                      "partitioned product")
    for mname, m in module.named_modules():
        if isinstance(m, ComputeDtype) and getattr(m, "bias", None) is not None:
            bspec = shardings.get(f"{mname}.bias" if mname else "bias", (None,))
            if is_split(bspec):
                if m.split is None or m.split.mode != "column" or bspec[0] != m.split.spec[0]:
                    raise NotImplementedError(f"{mname}.bias is split but its weight is not column-parallel")
                m.split.bias_split = True
        if isinstance(m, MoEMLP) and m.split:
            m.plan_expert_parallel(mesh)
    for m in module.modules():
        if hasattr(m, "plan_tensor_parallel"):
            m.plan_tensor_parallel()
    return module


def shard_module(module: nn.Module, mesh: Optional[Mesh]) -> Dict[str, Spec]:
    """Infer and apply the default rules' shardings to `module` on `mesh`;
    {} (and nothing changed) unless the mesh has a `model` or `expert` axis
    above 1.  Every rank builds the same whole module first (the same seed),
    so each chunk is the slice of the world of one's parameter at the
    rank's coordinate."""
    if mesh is None or not mesh.model_parallel:
        return {}
    shardings = infer_param_shardings(module, mesh)
    apply_param_shardings(module, shardings, mesh)
    return shardings


@torch.no_grad()
def gather_full_state(module: nn.Module, shardings: Dict[str, Spec], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The module's state dict with every split parameter gathered whole
    (along each split dimension over its axis's group): a collective every
    rank of the mesh calls."""
    out = {}
    for name, t in module.state_dict().items():
        for d, a in enumerate(shardings.get(name, ())):
            if a is not None:
                t = gather_from(t, mesh.axis_group((a,)), d)
        out[name] = t
    return out
