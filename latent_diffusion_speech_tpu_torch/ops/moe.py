"""Mixture-of-Experts feed-forward (GShard / Switch routing) in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/ops/moe.py::MoEMLP` on one
device: every expert lives on it, so there is no `mesh` and no expert
sharding (the trainer raises for `parallel.expert > 1`).  Routing is the
JAX module's:

* a softmax router in f32 whatever the compute dtype;
* top-k experts a token, ties broken toward the lower expert index (as
  `jax.lax.top_k`), the k gates renormalised to sum to one;
* a static capacity `min(max(ceil(k * S / E * capacity_factor), 1), k * S)`
  slots an expert;
* GShard's slot-major priority: every token's first choice outranks any
  token's second choice, and within a slot earlier tokens come first;
* a token past its expert's capacity is dropped (zero combine weight: the
  residual carries it); padded tokens are routed and take capacity too;
* the Switch auxiliary loss `E * sum_e f_e p_e` (f_e the share of tokens
  whose first choice is e, p_e the mean router probability of e).

The JAX module dispatches and combines with one-hot tensors of shape
(k S, E, capacity); at a training batch of 32 x 1024 tokens those alone
take gigabytes.  Here each routed token's slot is found from a cumulative
sum over the slot-major (k S, E) one-hot only, the tokens are gathered into
an (E, capacity + 1, C) bank (the extra row of each expert is a zero row
that empty slots read, and that dropped tokens point at), the experts run
as batched products, and each token gathers its k outputs back.  Every
index operation is a gather whose backward accumulates through PyTorch's
`index_put_`, which is deterministic under `torch.use_deterministic_algorithms`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.layers import ComputeDtype

__all__ = ["MoEMLP", "top_k_lowest_index"]


def top_k_lowest_index(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of (S, E)
    non-negative `probs`, in descending order, equal values taken lowest
    index first (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    vals, idx = [], []
    x = probs
    for _ in range(k):
        i = torch.argmax(x, dim=-1)  # the first maximum
        vals.append(torch.gather(probs, -1, i[:, None])[:, 0])
        idx.append(i)
        x = x.scatter(-1, i[:, None], -1.0)
    return torch.stack(vals, dim=-1), torch.stack(idx, dim=-1)


class MoEMLP(ComputeDtype, nn.Module):
    """Token-routed SwiGLU expert bank, a drop-in for a dense SwiGLU MLP:
    (B, T, C) -> (output (B, T, C), aux loss scalar).

    Parameters carry the flax module's names and layouts (`gate` (C, E),
    `w_gate` / `w_up` (E, C, F), `w_down` (E, F, C)), so
    `convert.llama_from_jax` moves them across unchanged.  The expert
    products run in `compute_dtype` (the banks' dtype unless
    `ops/layers.py::set_compute_dtype` set another), the router in f32.
    After each call `drop_fraction` holds the share of the k S routed
    choices that found no slot (a detached scalar on the input's device)."""

    def __init__(self, features: int, num_experts: int, intermediate_size: int, top_k: int = 2,
                 capacity_factor: float = 1.25):
        super().__init__()
        E, C, F_ = num_experts, features, intermediate_size
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.gate = nn.Parameter(torch.empty(C, E))
        self.w_gate = nn.Parameter(torch.empty(E, C, F_))
        self.w_up = nn.Parameter(torch.empty(E, C, F_))
        self.w_down = nn.Parameter(torch.empty(E, F_, C))
        self.drop_fraction = None

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The flax module's initialisers: every bank and the router N(0, 0.02)."""
        for p in (self.gate, self.w_gate, self.w_up, self.w_down):
            p.normal_(0.0, 0.02, generator=generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.w_gate.dtype if self._compute_dtype is None else self._compute_dtype

    def cast_experts(self, dtype: torch.dtype) -> "MoEMLP":
        """Store the expert banks in `dtype` (the serve path's one cast);
        the router stays f32."""
        for name in ("w_gate", "w_up", "w_down"):
            getattr(self, name).data = getattr(self, name).data.to(dtype)
        return self

    def capacity(self, tokens: int) -> int:
        k = min(self.top_k, self.num_experts)
        cap = max(int(math.ceil(k * tokens / self.num_experts * self.capacity_factor)), 1)
        return min(cap, k * tokens)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, C = x.shape
        E = self.num_experts
        k = min(self.top_k, E)
        S = B * T
        xf = x.reshape(S, C)
        probs = torch.softmax(xf.float() @ self.gate.float(), dim=-1)  # (S, E), f32
        gate_vals, gate_idx = top_k_lowest_index(probs, k)  # (S, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

        cap = self.capacity(S)
        # slot-major order: every token's first choice, then every second one
        expert = gate_idx.t().reshape(k * S)
        onehot = F.one_hot(expert, E)  # (k S, E), the only routing tensor
        pos = torch.gather(torch.cumsum(onehot, dim=0), 1, expert[:, None])[:, 0] - 1
        keep = pos < cap
        # row of each choice in the (E, cap + 1) bank; a dropped choice points
        # at its expert's zero row (index cap)
        row = expert * (cap + 1) + torch.where(keep, pos, cap)
        token = torch.arange(k * S, device=x.device) % S
        # which token fills each bank row (S: the zero row appended to xf)
        filler = torch.full((E * (cap + 1),), S, dtype=torch.long, device=x.device)
        filler = filler.index_put((row[keep],), token[keep])

        dtype = self.compute_dtype
        x_pad = torch.cat([xf.to(dtype), xf.new_zeros((1, C), dtype=dtype)])
        expert_in = x_pad[filler].view(E, cap + 1, C)
        h = F.silu(torch.bmm(expert_in, self.w_gate.to(dtype))) * torch.bmm(expert_in, self.w_up.to(dtype))
        out = torch.bmm(h, self.w_down.to(dtype)).reshape(E * (cap + 1), C)

        weight = (gate_vals.t().reshape(k * S) * keep).to(dtype)
        y = (out[row] * weight[:, None]).view(k, S, C).sum(dim=0)

        f_e = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
        p_e = probs.mean(dim=0)
        aux = E * torch.sum(f_e * p_e)
        self.drop_fraction = 1.0 - keep.float().mean().detach()
        return y.reshape(B, T, C), aux
