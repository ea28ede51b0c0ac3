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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.train.schedule import warmup_step_decay

__all__ = ["AdamWUpdates", "AdamW", "step_generator", "global_norm"]


def step_generator(seed: int, step: int, device, *stream: int) -> torch.Generator:
    """A generator on `device` seeded by a pure function of (seed, step,
    *stream): the counterpart of `fold_in(PRNGKey(seed), step)`."""
    hi, lo = np.random.SeedSequence([seed, step, *stream]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(hi) << 32 | int(lo))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm), from
    per-tensor norms taken by one multi-tensor launch."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class AdamWUpdates:
    """Mixin for a trainer with `_params` (its parameter list) and
    `_train_cfg()` (its `TrainConfig`): `_init_optimizer` once, then
    `apply_update()` after each backward.  `_configure_optimizer` sets the
    chain up from explicit values instead (`AdamW`)."""

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

    def apply_update(self) -> torch.Tensor:
        """Clip the parameters' `.grad` (or, with accumulation, their
        running mean on every k-th call) by their global norm (when clip is
        set) and take one AdamW step at the schedule's rate; returns the
        global norm of this call's gradients before clipping."""
        for p in self._params:
            # a parameter the batch does not reach gets a zero gradient, as
            # under jax.grad, so AdamW updates every parameter the same way
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        gnorm = global_norm(grads)
        if self.every > 1:
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
            norm = global_norm(grads)
        else:
            norm = gnorm
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
