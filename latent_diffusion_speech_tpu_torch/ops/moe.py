"""Mixture-of-Experts feed-forward (GShard / Switch routing) in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/ops/moe.py::MoEMLP`.  Routing
is the JAX module's:

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

Under data parallelism (`mesh`, set for a training forward by
`data_parallel`) JAX's S is the global batch's tokens, so the capacity and
each choice's slot are global.  Every rank gathers every rank's counts of
choices by (slot, row, expert) over the ranks that hold tokens of the
batch (the `data` axis, and `seq` under sequence parallelism: one
all-gather a layer) and places each of its choices in JAX's global order,
slot by slot, global row by global row, and within a row the `seq` chunks
in order: a choice's global slot is the choices of the earlier slots, of
the earlier rows in its slot, of the earlier chunks of its row, and its
own row's earlier tokens; it is kept when that slot is below the global
capacity.  Kept choices are a prefix of the rank's own in slot-major
order, so its bank holds them at their local positions.  The Switch loss
takes f_e from the gathered counts and p_e over the global batch: each
rank returns E sum_e f_e times its share of p_e scaled by the data axis's
size, whose mean over `data` (summed over `seq`, as the LM trainer reduces
its shares) is the global loss and its gradient.  A per-rank capacity
would drop other tokens: another model.  `stats` holds each call's
(f_e, p_e share), (2, E): the pipelined Llama carries them out of its
stages (JAX sows them for `loss_pp`).

Expert parallelism (the banks split by `parallel/sharding.py`'s rules,
JAX's `P("expert", None, "model")` and `P("expert", "model", None)`): the
batch is split over `data` only, so the ranks of an expert (and model)
group hold the same tokens and route them alike: the routing, the
capacity, the slots, the dropped share and the Switch loss are those of the
data axis's batch whatever `expert` is.  Each rank runs its E / expert
experts over its F / model hidden width on the slots those experts fill;
the bank's outputs are summed over the group (each expert's rows from the
rank that holds it, the hidden chunks' partial sums), one all-reduce a
layer, and every rank combines them whole.  The bank's input carries
Megatron's "f" (its gradient summed over the group).
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.layers import ComputeDtype
from latent_diffusion_speech_tpu_torch.parallel.tensor import copy_to, reduce_from

__all__ = ["MoEMLP", "top_k_lowest_index", "data_parallel", "current_routing"]


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
        self.stats = None  # the last call's (f_e, p_e) rows, (2, E)
        self.mesh = None  # a data-parallel `parallel.mesh.Mesh` with a group, set by `data_parallel`
        self.split = {}  # bank name -> its spec, when split over `expert` / `model` (parallel/sharding.py)
        self._ep = None  # (process group over the banks' axes, this rank's first expert)

    def plan_expert_parallel(self, mesh) -> None:
        """Set up the partitioned bank for the specs in `split`: the three
        banks split alike (experts over `expert`, the hidden width over
        `model`), this rank's first expert and the group over those axes."""
        gate = self.split.get("w_gate")
        if gate is None or self.split.get("w_up") != gate or self.split.get("w_down") != (gate[0], gate[2], None):
            raise NotImplementedError(f"MoEMLP: the expert banks are split unlike one another: {self.split}")
        axes = tuple(a for a in gate if a is not None)
        e0 = mesh.coordinate(gate[0]) * self.w_gate.shape[0] if gate[0] is not None else 0
        self._ep = (mesh.axis_group(axes), e0)

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

        # slot-major order: every token's first choice, then every second one
        expert = gate_idx.t().reshape(k * S)
        onehot = F.one_hot(expert, E)  # (k S, E), the only routing tensor
        pos = torch.gather(torch.cumsum(onehot, dim=0), 1, expert[:, None])[:, 0] - 1
        if self.mesh is None:
            cap = self.capacity(S)
            keep = pos < cap
        else:
            mesh = self.mesh
            D, n, d, c = mesh.size, mesh.axis_size("seq"), mesh.index, mesh.coordinate("seq")
            by_row = onehot.view(k, B, T, E)
            counts = by_row.sum(dim=2)  # (k, B, E): this rank's choices by slot, row and expert
            everyone = mesh.all_gather(counts, over=("data", "seq")).view(D, n, k, B, E)
            total = everyone.sum(dim=(0, 1, 3))  # (k, E)
            rows = everyone.sum(dim=1).permute(1, 0, 2, 3).reshape(k, D * B, E)  # by global row
            # choices before each of this rank's (slot, row): the earlier
            # slots, the earlier global rows of its slot, its row's earlier chunks
            base = ((total.cumsum(0) - total)[:, None] + (rows.cumsum(1) - rows)[:, d * B:(d + 1) * B]
                    + everyone[d, :c].sum(dim=0))
            in_row = torch.gather(by_row.cumsum(dim=2).view(k * S, E), 1, expert[:, None])[:, 0] - 1
            slot_row = torch.arange(k * S, device=x.device) // T  # slot * B + row
            global_cap = self.capacity(S * D * n)
            keep = base.view(k * B, E)[slot_row, expert] + in_row < global_cap
            cap = min(global_cap, k * S)
        # row of each choice in the (E, cap + 1) bank; a dropped choice points
        # at its expert's zero row (index cap)
        row = expert * (cap + 1) + torch.where(keep, pos, cap)
        token = torch.arange(k * S, device=x.device) % S
        # which token fills each bank row (S: the zero row appended to xf)
        filler = torch.full((E * (cap + 1),), S, dtype=torch.long, device=x.device)
        filler = filler.index_put((row[keep],), token[keep])

        dtype = self.compute_dtype
        xs, E_l = xf, self.w_gate.shape[0]
        if self._ep is not None:  # this rank's experts (and hidden chunk) only
            group, e0 = self._ep
            xs = copy_to(xf, group)
            filler = filler.view(E, cap + 1)[e0:e0 + E_l].reshape(-1)
        x_pad = torch.cat([xs.to(dtype), xf.new_zeros((1, C), dtype=dtype)])
        expert_in = x_pad[filler].view(E_l, cap + 1, C)
        h = F.silu(torch.bmm(expert_in, self.w_gate.to(dtype))) * torch.bmm(expert_in, self.w_up.to(dtype))
        out = torch.bmm(h, self.w_down.to(dtype)).reshape(E_l * (cap + 1), C)
        if self._ep is not None:
            # every expert's outputs on every rank: the local ones in place,
            # zeros elsewhere, summed over the group (the hidden chunks' partial
            # sums too), so the combine and the router's gradient are whole
            rows_before, rows_after = e0 * (cap + 1), (E - e0 - E_l) * (cap + 1)
            out = reduce_from(torch.cat([out.new_zeros((rows_before, C)), out, out.new_zeros((rows_after, C))]),
                              group)

        weight = (gate_vals.t().reshape(k * S) * keep).to(dtype)
        y = (out[row] * weight[:, None]).view(k, S, C).sum(dim=0)

        if self.mesh is None:
            f_e = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
            p_e = probs.mean(dim=0)
            self.drop_fraction = 1.0 - keep.float().mean().detach()
        else:
            S_all = S * D * n
            f_e = total[0].float() / S_all
            p_e = probs.sum(dim=0) * (D / S_all)
            self.drop_fraction = 1.0 - total.sum(0).clamp_max(global_cap).sum().float() / (k * S_all)
        self.stats = torch.stack([f_e, p_e])
        aux = E * torch.sum(f_e * p_e)
        return y.reshape(B, T, C), aux


@contextlib.contextmanager
def data_parallel(module: nn.Module, mesh):
    """Route every `MoEMLP` of `module` over the global batch of `mesh` (a
    `parallel.mesh.Mesh` with a group; its `data` and `seq` axes hold the
    batch's tokens) for the block: a training forward that every rank runs
    together.  Restored after."""
    layers = [m for m in module.modules() if isinstance(m, MoEMLP)]
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            m.mesh = None


def current_routing(modules):
    """A context manager factory that re-enters the meshes routing the
    `MoEMLP`s of `modules` now (`data_parallel`), for a recompute in a
    backward (`remat`) that runs after the caller's block has closed.
    Inside, the layers route as the forward did; after, their meshes,
    `stats` and `drop_fraction` are as the forward left them."""
    layers = [m for module in modules for m in module.modules() if isinstance(m, MoEMLP)]
    meshes = [m.mesh for m in layers]

    @contextlib.contextmanager
    def reenter():
        kept = [(m.mesh, m.stats, m.drop_fraction) for m in layers]
        for m, mesh in zip(layers, meshes):
            m.mesh = mesh
        try:
            yield
        finally:
            for m, (mesh, stats, drop) in zip(layers, kept):
                m.mesh, m.stats, m.drop_fraction = mesh, stats, drop

    return reenter
