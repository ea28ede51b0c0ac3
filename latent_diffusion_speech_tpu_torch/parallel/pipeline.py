"""Pipeline parallelism: GPipe microbatches over the mesh's `pipe` axis.

Counterpart of `latent_diffusion_speech_tpu/parallel/pipeline.py`.  The
JAX op runs the schedule as a `lax.scan` over ticks inside `shard_map`
(manual over `pipe` only), hands activations on with a `ppermute` ring
shift, and its backward is the scan's transpose.  Here each rank of the
`pipe` group runs its own stage's layers, and the schedule is JAX's:

* M microbatches through S stages take M + S - 1 ticks (bubble fraction
  (S - 1) / (M + S - 1)); at tick t stage s runs microbatch t - s, stage 0
  taking it from the input and every other stage from stage s - 1, and the
  last stage keeps result t - (S - 1).  A stage idles where JAX's computes
  a bubble tick's discarded garbage; the results are the same.
* Between ticks each stage sends its output to the next and receives its
  input from the previous, posted together (`batch_isend_irecv`), so every
  rank of the group runs the same exchanges in the same order.
* The results are broadcast from the last stage (JAX's masked `psum`).
* The activation is a pytree (tuple, list or dict) of tensors with a
  leading microbatch dimension; the whole tree travels together, so side
  inputs (masks, routing statistics) ride with their microbatch.

The backward is an `autograd.Function` that runs the schedule in reverse:
each stage backpropagates a microbatch's saved graph (or, with `remat`,
recomputes it) with the output gradient received from the next stage (the
last stage: its own), accumulating its parameters' gradients, and sends its
input's gradient back; the input activation's gradient lands on stage 0.
The outputs are replicated, so the last stage's own output gradient is the
one used: a loss that every rank computes alike from them counts once.
Each rank's parameter gradients are its stage's, so the gradients summed
over the `pipe` group are the whole model's (`count_once` makes the
replicated layers after the pipeline count once as well).

Stages: `stage_params` is a list of S per-stage values (a stage's modules,
PyTorch's idiom), or a pytree whose leaves carry a leading stage dimension
(`stack_stage_params`, JAX's layout); `stage_fn(stage_params_s, act)` maps
one microbatch's activation to one of the same structure and shapes, and
every tensor it should train is a leaf (a module's parameter, or a leaf
of `stage_params`).  JAX's `batch_axis` (each microbatch's rows sharded
over `data`) has no argument here: every rank holds its own rows, so each
passes its rows of every microbatch (dimension 1 of every leaf), laid out
as JAX's global program splits them (`train/lm_trainer.py::
_microbatch_rows`), and gets them back.
With S = 1 (or no process group) each microbatch runs through the stages in
turn, with `torch.utils.checkpoint` around each stage under `remat`; JAX's
S = 1 scan hands `stage_fn` the whole (M, mb, ...) activation instead,
which the LMs' stage functions cannot take (its `loss_pp` raises at
`pipe=1`).
A recompute under `remat` runs in the backward, after the caller's
contexts have closed; it re-enters those that route the forward (the
sequence-parallel contexts and the stages' MoE meshes, `_forward_scope`),
so that it rebuilds the forward's graph.
"""

from __future__ import annotations

from typing import Any, Callable, List

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from latent_diffusion_speech_tpu_torch.parallel.dist import exchange
from latent_diffusion_speech_tpu_torch.parallel.mesh import AXIS_PIPE

__all__ = ["pipeline_apply", "stack_stage_params", "count_once", "bubble_fraction"]


def stack_stage_params(stage_param_list) -> Any:
    """Stack a list of per-stage pytrees into one pytree whose leaves carry
    a leading stage dimension (JAX's layout)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), stage_param_list[0], *stage_param_list[1:])


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The share of ticks a stage idles: (S - 1) / (M + S - 1)."""
    return (stages - 1) / (microbatches + stages - 1)


def _n_stages(stage_params) -> int:
    if isinstance(stage_params, (list, tuple)):
        return len(stage_params)
    return pytree.tree_leaves(stage_params)[0].shape[0]


def _stage(stage_params, s: int):
    if isinstance(stage_params, (list, tuple)):
        return stage_params[s]
    return pytree.tree_map(lambda a: a[s], stage_params)


def _trained(stage) -> List[torch.Tensor]:
    """The tensors a stage trains: its modules' parameters and its leaf tensors."""
    out = []
    for leaf in pytree.tree_leaves(stage, is_leaf=lambda x: isinstance(x, nn.Module)):
        if isinstance(leaf, nn.Module):
            out += [p for p in leaf.parameters() if p.requires_grad]
        elif isinstance(leaf, torch.Tensor) and leaf.requires_grad:
            out.append(leaf)
    return out


def _forward_scope(stage) -> Callable[[], Any]:
    """A context manager factory that re-enters, around a recompute in the
    backward, what routes the forward now: the sequence-parallel contexts
    (`ops/attention.py`) and the meshes of the MoE layers among `stage`'s
    modules (`ops/moe.py::data_parallel`)."""
    from latent_diffusion_speech_tpu_torch.ops.attention import current_sequence_parallel
    from latent_diffusion_speech_tpu_torch.ops.moe import current_routing

    modules = [leaf for leaf in pytree.tree_leaves(stage, is_leaf=lambda x: isinstance(x, nn.Module))
               if isinstance(leaf, nn.Module)]
    seq, routing = current_sequence_parallel(), current_routing(modules)

    @contextlib.contextmanager
    def scope():
        with seq(), routing():
            yield

    return scope


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


class _Plan:
    """One call's schedule: the stage function, this rank's stage, the
    activation's structure and the pipe group's ranks."""

    def __init__(self, mesh, axis, stage_fn, stage_params, spec, M, remat):
        self.S, self.s = mesh.axis_size(axis), mesh.coordinate(axis)
        self.group = mesh.axis_group((axis,))
        self.next = mesh.peer(axis, self.s + 1) if self.s < self.S - 1 else None
        self.prev = mesh.peer(axis, self.s - 1) if self.s > 0 else None
        self.last = mesh.peer(axis, self.S - 1)
        self.stage_fn, self.stage_params, self.spec, self.M, self.remat = stage_fn, stage_params, spec, M, remat
        self.scope = _forward_scope(_stage(stage_params, self.s)) if remat else None

    def run(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        out = self.stage_fn(_stage(self.stage_params, self.s), pytree.tree_unflatten(leaves, self.spec))
        out_leaves, out_spec = pytree.tree_flatten(out)
        if out_spec != self.spec or any(o.shape != i.shape for o, i in zip(out_leaves, leaves)):
            raise ValueError("pipeline_apply: stage_fn must return an activation of its input's structure and shapes")
        return out_leaves


def _leaf(t: torch.Tensor, grad: bool) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_() if grad and t.is_floating_point() else t


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, n_x: int, grad: bool, *inputs):
        x = inputs[:n_x]
        M, S, s = plan.M, plan.S, plan.s
        meta = [(a.shape[1:], a.dtype, a.device) for a in x]
        saved: list = [None] * M
        results: list = [None] * M
        last = None
        for t in range(M + S - 1):
            m = t - s
            got = exchange(last if s < S - 1 and 0 <= t - 1 - s < M else None, plan.next,
                            meta if s > 0 and 0 <= m < M else None, plan.prev, plan.group)
            if not 0 <= m < M:
                continue
            inp = [_leaf(a, grad) for a in ([a[m] for a in x] if s == 0 else got)]
            with torch.set_grad_enabled(grad and not plan.remat):
                out = plan.run(inp)
            saved[m] = (inp, None if plan.remat else out)
            last = [o.detach() for o in out]
            if s == S - 1:
                results[m] = last
        outs = []
        for i, (shape, dtype, device) in enumerate(meta):
            buf = (torch.stack([r[i] for r in results]) if s == S - 1
                   else torch.empty((M, *shape), dtype=dtype, device=device))
            wire = _wire(buf)
            dist.broadcast(wire, plan.last, group=plan.group)
            outs.append(wire.bool() if dtype == torch.bool else wire)
        ctx.plan, ctx.saved, ctx.meta = plan, saved, meta
        ctx.n_rest = len(inputs) - n_x
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan, saved, meta = ctx.plan, ctx.saved, ctx.meta
        M, S, s = plan.M, plan.S, plan.s
        floats = [i for i, (_, dtype, _) in enumerate(meta) if dtype.is_floating_point]
        fmeta = [meta[i] for i in floats]
        gx = {i: torch.zeros((M, *meta[i][0]), dtype=meta[i][1], device=meta[i][2]) for i in floats}
        last = None
        for t in range(M + S - 2, -1, -1):
            m = t - s
            got = exchange(last if s > 0 and 0 <= t + 1 - s < M else None, plan.prev,
                            fmeta if s < S - 1 and 0 <= m < M else None, plan.next, plan.group)
            if not 0 <= m < M:
                continue
            inp, out = saved[m]
            saved[m] = None
            if out is None:  # remat: the stage again, now with its graph
                with torch.enable_grad(), plan.scope():
                    out = plan.run(inp)
            if s == S - 1:
                g_out = [grads[i][m] if grads[i] is not None else torch.zeros(meta[i][0], dtype=meta[i][1],
                                                                               device=meta[i][2])
                         for i in floats]
            else:
                g_out = got
            pairs = [(out[i], g) for i, g in zip(floats, g_out) if out[i].requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            g_in = [inp[i].grad if inp[i].grad is not None else torch.zeros_like(inp[i]) for i in floats]
            if s == 0:
                for i, g in zip(floats, g_in):
                    gx[i][m] = g
            else:
                last = g_in
        g_x = [gx.get(i) if s == 0 else (torch.zeros_like(gx[i]) if i in gx else None) for i in range(len(meta))]
        return (None, None, None, *g_x, *([None] * ctx.n_rest))


def pipeline_apply(mesh, stage_fn: Callable[[Any, Any], Any], stage_params: Any, x: Any, *,
                   pipe_axis: str = AXIS_PIPE, remat: bool = False) -> Any:
    """Run `x` (a pytree whose every leaf is (M, mb, ...): M microbatches)
    through the S stages of `stage_params`, GPipe-microbatched over
    `pipe_axis` of `mesh` (a `parallel.mesh.Mesh`; None: one process).
    Returns a pytree like `x`, every microbatch through every stage, the
    same on every rank of the pipe group.  A collective: every rank of the
    group calls it, and its backward, together.  Each rank passes and gets
    back its own rows of every microbatch.  See the module's docstring for
    `stage_params` and `remat`."""
    leaves, spec = pytree.tree_flatten(x)
    if not leaves:
        raise ValueError("pipeline_apply: empty activation pytree")
    M = leaves[0].shape[0]
    S = mesh.axis_size(pipe_axis) if mesh is not None and mesh.group is not None else 1
    n = _n_stages(stage_params)
    if S == 1:
        scope = _forward_scope(stage_params) if remat else None

        def contexts():  # the forward's, and the recompute's
            return contextlib.nullcontext(), scope()

        outs = []
        for m in range(M):
            h = pytree.tree_unflatten([a[m] for a in leaves], spec)
            for s in range(n):
                p = _stage(stage_params, s)
                h = (checkpoint(stage_fn, p, h, use_reentrant=False, context_fn=contexts) if remat
                     else stage_fn(p, h))
            outs.append(pytree.tree_leaves(h))
        return pytree.tree_unflatten([torch.stack(o) for o in zip(*outs)], spec)
    if n != S:
        raise ValueError(f"pipeline_apply: {n} stages over pipe={S}")
    plan = _Plan(mesh, pipe_axis, stage_fn, stage_params, spec, M, remat)
    # the Function's inputs, so that its outputs need a gradient; their own
    # gradients accumulate as the backward runs the stage's graph
    trained = _trained(stage_params[plan.s] if isinstance(stage_params, (list, tuple)) else stage_params)
    grad = torch.is_grad_enabled() and (any(a.requires_grad for a in leaves) or bool(trained))
    outs = _Pipeline.apply(plan, len(leaves), grad, *leaves, *trained)
    return pytree.tree_unflatten(list(outs), spec)


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, keep: bool):
        ctx.keep = keep
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def count_once(t: torch.Tensor, mesh, pipe_axis: str = AXIS_PIPE) -> torch.Tensor:
    """`t` (a value every rank of the pipe group computes alike, from the
    pipeline's replicated outputs and replicated layers), whose gradient
    flows on the last stage only: the gradients summed over the group
    count it once.  The identity without a pipe axis."""
    if mesh is None or mesh.group is None or mesh.axis_size(pipe_axis) <= 1:
        return t
    return _CountOnce.apply(t, mesh.coordinate(pipe_axis) == mesh.axis_size(pipe_axis) - 1)
