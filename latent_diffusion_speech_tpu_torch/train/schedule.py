"""Learning-rate schedules.

Counterpart of `latent_diffusion_speech_tpu/train/schedule.py`.
`warmup_step_decay` is the reference `StepLRWithWarmUp`: a linear ramp from
start_lr to lr over warm_up_steps, then lr * gamma^(step // decay_step).
The step is the optimizer's count of updates made so far, as optax counts
it: the first update uses step 0.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["warmup_step_decay"]


def warmup_step_decay(
    lr: float,
    start_lr: float = 1e-5,
    warm_up_steps: int = 1000,
    decay_step: int = 300_000,
    gamma: float = 0.5,
) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return start_lr + (lr - start_lr) * (step / max(warm_up_steps, 1))
        return lr * gamma ** (step // decay_step)

    return schedule
