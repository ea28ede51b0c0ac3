"""A card's peak rate and a training step's FLOPs, for the trainers' MFU.

Counterpart of `latent_diffusion_speech_tpu/utils/flops.py`.  The peak is
the bf16 dense rate of the card by `torch.cuda.get_device_name` (public
datasheet figures: H100 SXM 989 TFLOP/s, H100 PCIe 756 TFLOP/s), whatever
the step's dtype, as the JAX package divides by the bf16 peak; any other
device gives None, and the trainers then log no `train/mfu`.

`StepFlops` counts one step's FLOPs: every product and convolution PyTorch
runs, by `torch.utils.flop_counter`'s formulas, seen through a dispatch mode
that passes each operation through unchanged (`FlopCounterMode` itself
tracks modules with gradient hooks, which change the order in which
gradients sum, so a counted step would differ in its last bits from an
uncounted one), and the hand-written kernels that it cannot see (launched
through ctypes) from their shapes: K4 in the UNet's self-attention,
4 B T^2 C forward and twice that backward (the products an autograd
attention would run), and K6's scores, 2 N K D, which the trainer adds.
The JAX trainers read XLA's cost analysis of the whole step, which also
counts elementwise work; this counts products only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["device_peak_flops", "step_mfu", "StepFlops", "FlopsByShape"]

# bf16 dense FLOP/s by device name, the more specific name first
_PEAKS = [
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
]


def device_peak_flops(device) -> Optional[float]:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((peak for sub, peak in _PEAKS if sub in name), None)


def step_mfu(flops: Optional[float], steps_per_sec: float, device) -> Optional[float]:
    """Model FLOP utilisation of a step rate: FLOPs a step x steps/s over
    the card's bf16 peak; None when either is unknown.  Under data
    parallelism a rank's FLOPs over its card's peak is the world's FLOPs
    over the world's peak."""
    peak = device_peak_flops(device)
    return None if flops is None or not peak else flops * steps_per_sec / peak


class _Counter(TorchDispatchMode):
    """Runs every operation as it is, adding its FLOPs where PyTorch has a
    formula for it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


class StepFlops:
    """Context manager over one training step: `total` afterwards holds the
    step's FLOPs (forward and backward)."""

    def __init__(self, module: Optional[torch.nn.Module] = None):
        from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import SelfAttention

        self._attn = [m for m in module.modules() if isinstance(m, SelfAttention)] if module is not None else []
        self._kernels = 0.0
        self.total = 0.0

    def add(self, flops: float) -> None:
        self._kernels += flops

    def _attention_hook(self, module, args, out) -> None:
        x = args[0]
        if x.is_cuda and module.attn_impl != "pallas":  # K4: no FLOP the counter can see
            B, T, C = x.shape
            self.add(4.0 * B * T * T * C * (3 if torch.is_grad_enabled() else 1))

    def __enter__(self) -> "StepFlops":
        self._hooks = [m.register_forward_hook(self._attention_hook) for m in self._attn]
        self._mode = _Counter()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        for h in self._hooks:
            h.remove()
        self.total = float(self._mode.flops) + self._kernels


class FlopsByShape:
    """A training loop's step FLOPs, counted under `StepFlops` the first time
    a batch shape is seen and kept by shape."""

    def __init__(self, module: Optional[torch.nn.Module] = None):
        self.module, self.flops = module, {}

    def step(self, batch: dict, run, kernel_flops: float = 0.0):
        """(run(), the step's FLOPs): `run` is the step on `batch`;
        `kernel_flops` adds what a hand-written kernel of the step does."""
        key = tuple((k, tuple(v.shape)) for k, v in sorted(batch.items()))
        if key in self.flops:
            return run(), self.flops[key]
        with StepFlops(self.module) as counter:
            counter.add(kernel_flops)
            out = run()
        self.flops[key] = counter.total
        return out, counter.total
