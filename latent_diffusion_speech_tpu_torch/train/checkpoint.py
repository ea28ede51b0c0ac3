"""Checkpoint save / scan-resume.

Counterpart of `latent_diffusion_speech_tpu/train/checkpoint.py`, with the
same file names and retention: checkpoints are `model_<step>.ckpt` files in
the experiment dir and resume picks the highest step; `keep` (the config's
`last_save_model_num`) deletes older ones with their sidecars; an optional
`model_<step>.meta.json` carries the data-stream position and
`model_<step>.<name>.ckpt` sidecars carry extra state (the EMA weights).
Contents are `torch.save` of state dicts, loaded with `weights_only=True`;
the port does not read the JAX package's flax msgpack checkpoints
(`convert.py` moves weights from a flax tree).  A checkpoint of parameters
split across ranks is a `model_<step>.sharded` directory
(`train/sharded_checkpoint.py`): the step scan and the retention see both
formats, as JAX's do.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_checkpoint_meta",
    "load_checkpoint_extra",
    "latest_checkpoint_step",
    "apply_retention",
]

_STEP_RE = re.compile(r"model_(\d+)\.ckpt$")
# sharded checkpoints are directories (train/sharded_checkpoint.py)
_STEP_ANY_RE = re.compile(r"model_(\d+)(\.ckpt|\.sharded)$")


def save_checkpoint(
    expdir: str | Path,
    step: int,
    params: Any,
    opt_state: Optional[Any] = None,
    keep: int = 4,
    meta: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> Path:
    """`meta` (JSON-serializable) is written as `model_<step>.meta.json`;
    `extra` ({name: state}) as `model_<step>.<name>.ckpt` sidecars, kept
    and deleted with their checkpoint."""
    expdir = Path(expdir)
    expdir.mkdir(parents=True, exist_ok=True)
    payload = {"step": step, "params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    path = expdir / f"model_{step}.ckpt"
    torch.save(payload, path)
    if meta is not None:
        path.with_suffix(".meta.json").write_text(json.dumps(meta))
    for name, state in (extra or {}).items():
        torch.save(state, path.with_suffix(f".{name}.ckpt"))

    if keep and keep > 0:
        apply_retention(expdir, keep)
    return path


def _steps(expdir: Path) -> dict:
    steps: dict = {}
    for p in expdir.glob("model_*"):
        if m := _STEP_ANY_RE.match(p.name):
            steps.setdefault(int(m.group(1)), []).append(p)
    return steps


def apply_retention(expdir: str | Path, keep: int) -> None:
    """Keep the newest `keep` steps across both formats (single files and
    sharded directories), deleting older ones with their meta and sidecars."""
    expdir = Path(expdir)
    steps = _steps(expdir)
    for step in sorted(steps)[:-keep]:
        for p in steps[step]:
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
        (expdir / f"model_{step}.meta.json").unlink(missing_ok=True)
        for sidecar in expdir.glob(f"model_{step}.*.ckpt"):
            sidecar.unlink(missing_ok=True)


def latest_checkpoint_step(expdir: str | Path) -> Optional[int]:
    """Highest checkpointed step in `expdir` (either format), or None."""
    expdir = Path(expdir)
    if not expdir.exists():
        return None
    steps = _steps(expdir)
    return max(steps) if steps else None


def _resolve(expdir: Path, step: Optional[int]) -> Optional[int]:
    return latest_checkpoint_step(expdir) if step is None else step


def load_checkpoint_meta(expdir: str | Path, step: Optional[int] = None) -> dict:
    """The meta sidecar for `step` (default: latest), or {} if none exists."""
    expdir = Path(expdir)
    step = _resolve(expdir, step)
    path = expdir / f"model_{step}.meta.json"
    if step is None or not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def load_checkpoint_extra(expdir: str | Path, name: str, step: Optional[int] = None) -> Optional[Any]:
    """A `model_<step>.<name>.ckpt` sidecar (default: latest step), on the
    CPU, or None when absent."""
    expdir = Path(expdir)
    step = _resolve(expdir, step)
    path = expdir / f"model_{step}.{name}.ckpt"
    if step is None or not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(expdir: str | Path, step: Optional[int] = None) -> Tuple[int, Any, Optional[Any]]:
    """(step, params, opt_state or None), on the CPU. Raises if there is no
    checkpoint."""
    expdir = Path(expdir)
    step = _resolve(expdir, step)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {expdir}")
    payload = torch.load(expdir / f"model_{step}.ckpt", map_location="cpu", weights_only=True)
    return payload["step"], payload["params"], payload.get("opt_state")
