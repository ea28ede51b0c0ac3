"""The optimizer the port's trainers share: optax's chain in PyTorch.

Both JAX trainers build `optax.chain(clip_by_global_norm(max) when max > 0,
adamw(warmup_step_decay(...), weight_decay))`, wrapped in
`optax.MultiSteps(chain, k)` when `gradient_accumulation_steps` k > 1; the
JAX codec trainer builds `optax.adamw(lr, b1=0.8, b2=0.99)` (optax's weight
decay 1e-4, no clipping) for each of its two networks.  `AdamWUpdates` is
that chain over `torch.optim.AdamW` (eps 1e-8, decoupled weight decay): the
gradients' global norm, g * min(1, max / |g|) on the device, and the rate of
update k (counted from 0, as optax counts) set before each step.  With
k > 1 each call folds the gradients into a running mean,
acc + (g - acc) / (n + 1) (MultiSteps' Welford mean), and only every k-th
call clips the mean and takes the AdamW step; the other calls leave the
parameters as they are.  The schedule counts those steps, and the
accumulator and its position ride in the optimizer state, so a run
interrupted between micro-steps resumes where it stopped.
`step_generator` is the per-step random stream, the counterpart of
`fold_in(PRNGKey(seed), step)`.

Under data parallelism (`mesh`, a `parallel.mesh.Mesh` with a group) the
gradients are averaged over the ranks before the norm, so the norm, the
clipping and the step are the global batch's, as in JAX's one global
program: one coalesced all-reduce an update, the scalars the caller passes
(`reduce`, its loss) averaged in the same buffer.  With accumulation only
the update's accumulated mean is reduced (the mean over ranks of the
micro-steps' means, which is MultiSteps' mean of global gradients), each
micro-step reduces its scalars alone, and the norm returned for a
micro-step is its local gradients'.  The average runs over the data axis's
group only; with parameters split over `model` or `expert` (`_param_axes`,
set by the trainer) the norm that clips is the global tensors'
(`global_norm`), so every rank clips by the same factor, and AdamW, the
weight decay and the EMA act on each rank's chunks.  Under sequence or
pipeline parallelism (`_share_axes`, set by the LM trainer) each rank's
gradients are its share of its data coordinate's (its token chunk's, its
stage's), so they are summed over `seq` and `pipe` in the same all-reduce
that averages them over `data`; every rank of the group then holds the
whole gradient of every parameter it holds, and the norm, taken after that
reduction, counts each leaf once.  A micro-step's returned norm (with
accumulation) is then of the rank's share.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from latent_diffusion_speech_tpu_torch.train.schedule import warmup_step_decay

__all__ = ["AdamWUpdates", "AdamW", "step_generator", "global_norm"]


def step_generator(seed: int, step: int, device, *stream: int) -> torch.Generator:
    """A generator on `device` seeded by a pure function of (seed, step,
    *stream): the counterpart of `fold_in(PRNGKey(seed), step)`."""
    hi, lo = np.random.SeedSequence([seed, step, *stream]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(hi) << 32 | int(lo))


def global_norm(tensors, mesh=None, axes: Optional[Sequence[tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm), from
    per-tensor norms taken by one multi-tensor launch.  Under a mesh whose
    parameters are split (`axes`: the mesh axes each tensor is split over,
    () for a whole one) it is the norm of the global tensors: the squares
    of the tensors split over the same axes are summed over those axes'
    group, and each whole tensor, the same on every rank, counts once."""
    tensors = list(tensors)
    norms = torch.stack(torch._foreach_norm(tensors))
    if mesh is None or axes is None or not any(axes):
        return torch.linalg.vector_norm(norms)
    squares = norms.float() ** 2
    total = squares.new_zeros(())
    for key in sorted(set(axes)):
        part = squares[torch.tensor([a == key for a in axes], device=squares.device)].sum()
        if key:
            dist.all_reduce(part, group=mesh.axis_group(key))
        total = total + part
    return total.sqrt()


class AdamWUpdates:
    """Mixin for a trainer with `_params` (its parameter list) and
    `_train_cfg()` (its `TrainConfig`): `_init_optimizer` once, then
    `apply_update()` after each backward.  `_configure_optimizer` sets the
    chain up from explicit values instead (`AdamW`)."""

    mesh = None  # a `parallel.mesh.Mesh` whose ranks average their gradients (None: one process)
    _param_axes = None  # the mesh axes each of `_params` is split over (None: every parameter whole)
    _share_axes = ("data",)  # averaged over `data`, summed over the others (the ranks' shares of one loss)

    def _train_cfg(self):
        raise NotImplementedError

    def _init_optimizer(self) -> None:
        tcfg = self._train_cfg()
        self._configure_optimizer(
            warmup_step_decay(tcfg.lr, tcfg.start_lr, tcfg.warm_up_steps, tcfg.decay_step, tcfg.gamma),
            tcfg.weight_decay,
            clip=tcfg.clip_grad_norm if tcfg.clip_grad_norm and tcfg.clip_grad_norm > 0 else None,
            every=max(1, tcfg.gradient_accumulation_steps),
        )

    def _configure_optimizer(self, schedule: Callable[[int], float], weight_decay: float,
                             clip: Optional[float] = None, betas: Tuple[float, float] = (0.9, 0.999),
                             every: int = 1) -> None:
        self.schedule, self.weight_decay, self.clip, self.betas, self.every = (
            schedule, weight_decay, clip, betas, every)
        self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        self.optimizer = torch.optim.AdamW(self._params, lr=self.schedule(0), betas=self.betas, eps=1e-8,
                                           weight_decay=self.weight_decay)
        self.opt_count = 0  # updates since the optimizer was made: the schedule's step
        self.mini_step = 0  # micro-steps folded into `_acc` since the last update
        self._acc = None

    def _opt_state(self) -> dict:
        state = {"optimizer": self.optimizer.state_dict(), "count": self.opt_count}
        if self.every > 1:
            state.update(mini_step=self.mini_step, acc=None if self._acc is None else list(self._acc))
        return state

    def _load_opt_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.opt_count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self._acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self._params)]

    def _global_norm(self, grads) -> torch.Tensor:
        return global_norm(grads, self.mesh, self._param_axes)

    def _opt_leaves(self, names: Sequence[str]) -> dict:
        """The optimizer state as named leaves for a sharded checkpoint:
        each parameter's AdamW moments and step (zeros before its first
        update), the update count and, with accumulation, the running mean
        and its position."""
        state = self.optimizer.state
        out = {"count": int(self.opt_count)}
        for n, p in zip(names, self._params):
            st = state.get(p, {})
            out[f"exp_avg/{n}"] = st.get("exp_avg", torch.zeros_like(p))
            out[f"exp_avg_sq/{n}"] = st.get("exp_avg_sq", torch.zeros_like(p))
            out[f"step/{n}"] = st.get("step", torch.zeros((), dtype=torch.float32))
        if self.every > 1:
            out["mini_step"] = int(self.mini_step)
            out["has_acc"] = int(self._acc is not None)
            for n, p, a in zip(names, self._params, self._acc or [None] * len(self._params)):
                out[f"acc/{n}"] = a if a is not None else torch.zeros_like(p)
        return out

    @staticmethod
    def _opt_specs(names: Sequence[str], shardings: dict) -> dict:
        """The specs of `_opt_leaves`: each per-parameter leaf its parameter's."""
        specs = {}
        for n in names:
            if n in shardings:
                for kind in ("exp_avg", "exp_avg_sq", "acc"):
                    specs[f"{kind}/{n}"] = shardings[n]
        return specs

    def _load_opt_leaves(self, leaves: dict, names: Sequence[str]) -> None:
        """Inverse of `_opt_leaves` (after `_reset_optimizer`)."""
        state = {i: {"step": leaves[f"step/{n}"], "exp_avg": leaves[f"exp_avg/{n}"],
                     "exp_avg_sq": leaves[f"exp_avg_sq/{n}"]} for i, n in enumerate(names)}
        self.optimizer.load_state_dict({"state": state, "param_groups": self.optimizer.state_dict()["param_groups"]})
        self.opt_count = int(leaves["count"])
        if self.every > 1:
            self.mini_step = int(leaves.get("mini_step", 0))
            self._acc = ([leaves[f"acc/{n}"].to(p.device) for n, p in zip(names, self._params)]
                         if leaves.get("has_acc") else None)

    def _average(self, tensors) -> None:
        if self.mesh is not None:
            self.mesh.all_reduce_mean_(tensors, over=self._share_axes)

    def apply_update(self, reduce: Sequence[torch.Tensor] = (),
                     guard: Optional[Callable[[], None]] = None) -> torch.Tensor:
        """Clip the parameters' `.grad` (or, with accumulation, their
        running mean on every k-th call) by their global norm (when clip is
        set) and take one AdamW step at the schedule's rate; returns the
        global norm of this call's gradients before clipping.  Under a mesh
        the gradients and the tensors of `reduce` are averaged over its
        ranks first (in place).  `guard`, when given, runs after that
        average and before anything changes: it may raise (the LM's
        non-finite loss check, the same on every rank)."""
        for p in self._params:
            # a parameter the batch does not reach gets a zero gradient, as
            # under jax.grad, so AdamW updates every parameter the same way
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        if self.every > 1:
            gnorm = self._global_norm(grads)
            self._average(list(reduce))
            if guard is not None:
                guard()
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # acc + (g - acc) / (n + 1), MultiSteps' running mean
            torch._foreach_add_(self._acc, torch._foreach_div(torch._foreach_sub(grads, self._acc),
                                                              float(self.mini_step + 1)))
            self.mini_step += 1
            if self.mini_step < self.every:
                return gnorm
            for p, a in zip(self._params, self._acc):
                p.grad = a
            grads, self._acc, self.mini_step = self._acc, None, 0
            self._average(grads)
            norm = self._global_norm(grads)
        else:
            self._average(grads + list(reduce))
            if guard is not None:
                guard()
            gnorm = norm = self._global_norm(grads)
        if self.clip is not None:
            # g * min(1, max / |g|), on the device: no host sync
            torch._foreach_mul_(grads, torch.clamp(self.clip / norm, max=1.0))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.opt_count)
        self.optimizer.step()
        self.opt_count += 1
        return gnorm


class AdamW(AdamWUpdates):
    """The chain on its own, over `params`: `optax.adamw(lr, b1, b2,
    weight_decay)` (optax's default weight decay is 1e-4) with a constant
    rate, as the JAX codec trainer builds one for each network."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 1e-4):
        self._params = list(params)
        self._configure_optimizer(lambda count: lr, weight_decay, betas=betas)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
