"""The optimizer the port's trainers share: optax's chain in PyTorch.

Both JAX trainers build `optax.chain(clip_by_global_norm(max) when max > 0,
adamw(warmup_step_decay(...), weight_decay))`.  `AdamWUpdates` is that chain
over `torch.optim.AdamW` (betas (0.9, 0.999), eps 1e-8, decoupled weight
decay): the gradients' global norm, g * min(1, max / |g|) on the device, and
the rate of update k (counted from 0, as optax counts) set before each step.
`step_generator` is the per-step random stream, the counterpart of
`fold_in(PRNGKey(seed), step)`.
"""

from __future__ import annotations

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.train.schedule import warmup_step_decay

__all__ = ["AdamWUpdates", "step_generator", "global_norm"]


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
    `apply_update()` after each backward."""

    def _train_cfg(self):
        raise NotImplementedError

    def _init_optimizer(self) -> None:
        tcfg = self._train_cfg()
        self.schedule = warmup_step_decay(tcfg.lr, tcfg.start_lr, tcfg.warm_up_steps, tcfg.decay_step, tcfg.gamma)
        self.clip = tcfg.clip_grad_norm if tcfg.clip_grad_norm and tcfg.clip_grad_norm > 0 else None
        self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        tcfg = self._train_cfg()
        self.optimizer = torch.optim.AdamW(self._params, lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=tcfg.weight_decay)
        self.opt_count = 0  # updates since the optimizer was made: the schedule's step

    def _opt_state(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.opt_count}

    def _load_opt_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.opt_count = int(state["count"])

    def apply_update(self) -> torch.Tensor:
        """Clip the parameters' `.grad` by their global norm (when the
        config's clip_grad_norm > 0) and take one AdamW step at the
        schedule's rate; returns the global norm before clipping."""
        for p in self._params:
            # a parameter the batch does not reach gets a zero gradient, as
            # under jax.grad, so AdamW updates every parameter the same way
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        gnorm = global_norm(grads)
        if self.clip is not None:
            # g * min(1, max / |g|), on the device: no host sync
            torch._foreach_mul_(grads, torch.clamp(self.clip / gnorm, max=1.0))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.opt_count)
        self.optimizer.step()
        self.opt_count += 1
        return gnorm
