"""LoRA: low-rank adaptation over a state dict of the port's modules.

Counterpart of `latent_diffusion_speech_tpu/train/lora.py`.  `lora_init`
builds (a, b) factor pairs for every product weight whose flax path matches
the target patterns, `lora_apply` returns the merged state
(W + scale * a @ b, reshaped to the weight), and training optimises only the
factors: with `state = {n: p.detach() for n, p in module.named_parameters()}`,
`torch.func.functional_call(module, lora_apply(state, lora), args)`
differentiated in `lora`.

The patterns are the JAX package's, matched against each weight's flax path
(`convert.py`'s name map read backwards: `unet.down_0_attn_0.attn1.to_q.weight`
is `unet/down_0_attn_0/attn1/to_q/kernel`), so both packages pick the same
weights, and the factors keep JAX's shapes and keys: a JAX LoRA tree is used
as it is.  A Dense kernel is (in, out) in flax and a torch `weight` (out, in);
a 1-D conv kernel (k, in, out) and a torch weight (out, in, k): a factor
product (fan_in, out) is reshaped to flax's kernel shape, then moved to
torch's layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import torch

__all__ = ["lora_init", "lora_apply", "lora_param_count", "flax_path"]

DEFAULT_TARGETS = (r"(to_q|to_k|to_v|to_out|query|key|value|out|ff_proj|ff_out|proj_in|proj_out)/kernel$",)


def flax_path(name: str) -> str:
    """The flax path of a state-dict entry: `a.b.weight` -> `a/b/kernel`
    for a product weight (other leaves keep their last name)."""
    module, _, leaf = name.rpartition(".")
    leaf = "kernel" if leaf == "weight" else leaf
    return f"{module.replace('.', '/')}/{leaf}" if module else leaf


def _flax_shape(weight: torch.Tensor) -> tuple:
    """The flax kernel shape of a torch product weight."""
    if weight.dim() == 2:
        return (weight.shape[1], weight.shape[0])
    return (weight.shape[2], weight.shape[1], weight.shape[0])


def _to_torch(kernel: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel in torch's layout ((in, out) -> (out, in);
    (k, in, out) -> (out, in, k))."""
    return kernel.T if kernel.dim() == 2 else kernel.permute(2, 1, 0)


def lora_init(
    params: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    rank: int = 8,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The factors: {flax path: {"a": (fan_in, rank) N(0, 1/fan_in), "b":
    (rank, fan_out) zeros}} for every 2-D or 3-D weight whose flax path
    matches a target (so the delta starts at 0), drawn from `generator` in
    the state dict's order, on each weight's device."""
    out = {}
    for name, leaf in params.items():
        path = flax_path(name)
        if leaf.dim() < 2 or not name.endswith(".weight") or not any(re.search(t, path) for t in targets):
            continue
        shape = _flax_shape(leaf)
        fan_in = 1
        for d in shape[:-1]:
            fan_in *= d
        a = torch.randn((fan_in, rank), generator=generator) / fan_in ** 0.5
        out[path] = {"a": a.to(leaf.device), "b": torch.zeros((rank, shape[-1]), device=leaf.device)}
    return out


def lora_apply(params: Mapping[str, torch.Tensor], lora: Mapping, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The merged state: W + scale * (a @ b) in W's layout for each weight
    with factors; differentiable in `lora`."""
    out = {}
    for name, leaf in params.items():
        path = flax_path(name)
        if name.endswith(".weight") and path in lora:
            delta = (lora[path]["a"] @ lora[path]["b"]).reshape(_flax_shape(leaf))
            leaf = leaf + scale * _to_torch(delta).to(leaf.dtype)
        out[name] = leaf
    return out


def lora_param_count(lora: Mapping) -> int:
    return sum(int(v["a"].numel() + v["b"].numel()) for v in lora.values())
