"""Debug / sanitizer switches (`Config.debug`).

Counterpart of `latent_diffusion_speech_tpu/train/debug.py`:

* ``debug_nans`` turns on `torch.autograd.set_detect_anomaly` (the JAX
  package's ``jax_debug_nans``): a backward op that produces a NaN raises
  with the forward op's traceback.  Slow; a debugging mode.
* ``check_interval`` - every N steps the trainer asserts that every
  parameter and the step's loss are finite, raising :class:`NonFiniteError`
  that names the offending parameters.  One multi-tensor reduction computes
  every tensor's finiteness, so a check costs one device read.
* ``dump_on_nan`` - when the check trips, the batch and the step are written
  to ``<expdir>/nan_dump_<step>.npz`` for offline replay.

Trainers call :func:`install` / :func:`check_step`; all is a no-op with the
default config (all off).  A "tree" here is a mapping of names to tensors
(`dict(module.named_parameters())`), nested mappings named with dots.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.config import DebugConfig

__all__ = [
    "DebugConfig",
    "NonFiniteError",
    "install",
    "tree_nonfinite_paths",
    "assert_tree_finite",
    "dump_nan_batch",
    "check_step",
]


class NonFiniteError(RuntimeError):
    """A parameter/loss sanity check found NaN/Inf; `.paths` names the tensors."""

    def __init__(self, message: str, paths: Optional[list] = None):
        super().__init__(message)
        self.paths = paths or []


@contextlib.contextmanager
def install(dcfg: Optional[DebugConfig]):
    """Context manager applying the process-global debug flags, restored on exit."""
    if dcfg is None or not dcfg.debug_nans:
        yield
        return
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        elif isinstance(val, torch.Tensor) and val.is_floating_point():
            out[path] = val
    return out


def _finite_flags(tensors, extra=None) -> np.ndarray:
    """Per tensor (and `extra`, the loss, last): all finite?  x * 0 is 0
    where x is finite and NaN where it is NaN or Inf, so its norm is 0 or
    NaN (no overflow of large finite values); one multi-tensor launch each,
    one device read for all."""
    tensors = [t.detach() for t in tensors]
    if extra is not None:
        device = tensors[0].device if tensors else None
        tensors.append(torch.as_tensor(extra, device=device).detach().reshape(-1).float())
    if not tensors:
        return np.zeros(0, bool)
    norms = torch._foreach_norm(torch._foreach_mul(tensors, 0.0))
    return torch.isfinite(torch.stack([n.float() for n in norms])).cpu().numpy()


def tree_nonfinite_paths(tree: Mapping) -> list:
    """Names of every tensor holding NaN/Inf (empty list = all finite)."""
    flat = _flatten(tree)
    flags = _finite_flags(list(flat.values()))
    return [name for name, ok in zip(flat, flags) if not ok]


def assert_tree_finite(tree: Mapping, name: str = "params") -> None:
    bad = tree_nonfinite_paths(tree)
    if bad:
        shown = ", ".join(bad[:8]) + (" …" if len(bad) > 8 else "")
        raise NonFiniteError(f"non-finite values in {name} ({len(bad)} tensors): {shown}", paths=bad)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def dump_nan_batch(expdir: str, step: int, batch: Dict[str, Any], loss=None) -> Path:
    """Write the batch that produced a non-finite loss for offline replay."""
    path = Path(expdir) / f"nan_dump_{step}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: _numpy(v) for k, v in batch.items() if v is not None}
    if loss is not None:
        arrays["__loss__"] = _numpy(loss)
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)
    return path


def check_step(
    dcfg: Optional[DebugConfig],
    step: int,
    params: Mapping,
    loss,
    batch: Optional[Dict[str, Any]] = None,
    expdir: str = ".",
) -> None:
    """Trainer hook: the finiteness assertion every `check_interval` steps,
    with the batch dumped on failure when `dump_on_nan`.  A no-op off
    cadence, so the other steps never wait for the device."""
    if dcfg is None or dcfg.check_interval <= 0 or step % dcfg.check_interval != 0:
        return
    flat = _flatten(params)
    flags = _finite_flags(list(flat.values()), extra=loss)
    loss_ok = bool(flags[-1]) if loss is not None else True
    bad = [name for name, ok in zip(flat, flags) if not ok]
    if loss_ok and not bad:
        return
    dump = None
    if dcfg.dump_on_nan and batch is not None:
        dump = dump_nan_batch(expdir, step, batch, loss)
    detail = f"loss={'non-finite' if not loss_ok else 'finite'}, bad parameter tensors={len(bad)}"
    if bad:
        detail += ": " + ", ".join(bad[:8]) + (" …" if len(bad) > 8 else "")
    if dump is not None:
        detail += f" (batch dumped to {dump})"
    raise NonFiniteError(f"sanity check failed at step {step}: {detail}", paths=bad)
