"""Training metrics: a JSONL sink, a config snapshot, TensorBoard when it imports.

Counterpart of `latent_diffusion_speech_tpu/utils/logger.py::MetricsLogger`
for one process (the JAX package's rank-0 gate has nothing to gate here).
Scalars go to `<expdir>/logs/metrics.jsonl` (one JSON object a call) and, when
`torch.utils.tensorboard` imports, to TensorBoard; `config_snapshot` (a
`config_to_dict` dict) is written to `<expdir>/config.yaml`.  Validation audio
is written as 16-bit WAV files under `<expdir>/logs/audio/` (and to
TensorBoard when it is there), so it is kept on machines without TensorBoard.
`log_spec_comparison` always writes the validation triptych's three arrays
(|pred - gt|, gt, pred) to `<expdir>/logs/spec/<tag>_<step>.npz`, and the
JAX logger's figure to TensorBoard when both TensorBoard and matplotlib
import.
"""

from __future__ import annotations

import json
import logging
import re
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["MetricsLogger"]

_log = logging.getLogger(__name__)


def _safe(tag: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", tag)


class MetricsLogger:
    def __init__(self, expdir: str | Path, config_snapshot: Optional[dict] = None, use_tensorboard: bool = True):
        self.expdir = Path(expdir)
        (self.expdir / "logs").mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.expdir / "logs" / "metrics.jsonl", "a")
        if config_snapshot is not None:
            import yaml

            (self.expdir / "config.yaml").write_text(yaml.safe_dump(config_snapshot, sort_keys=False))
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.expdir / "logs"))
            except ImportError as e:
                _log.warning("TensorBoard requested but unavailable (%s); scalars go to JSONL only", e)
        self._t0 = time.time()
        self._figure_error_logged = False

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def log_audio(self, step: int, tag: str, audio, sample_rate: int) -> Path:
        """Write `audio` as `logs/audio/<tag>_<step>.wav` (and to TensorBoard)."""
        from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav

        audio = np.asarray(audio, np.float32).reshape(-1)
        path = self.expdir / "logs" / "audio" / f"{_safe(tag)}_{step}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(path, audio, sample_rate)
        if self._tb is not None:
            self._tb.add_audio(tag, audio.reshape(-1, 1), step, sample_rate=sample_rate)
        return path

    def log_spec_comparison(self, step: int, tag: str, pred, gt) -> Path:
        """The spectrogram triptych |pred - gt| / gt / pred of (T, M) arrays,
        written as `logs/spec/<tag>_<step>.npz` (each (M, T)), and as a
        figure to TensorBoard when matplotlib imports."""
        pred = np.asarray(pred, np.float32).T
        gt = np.asarray(gt, np.float32).T
        path = self.expdir / "logs" / "spec" / f"{_safe(tag)}_{step}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, abs_err=np.abs(pred - gt), gt=gt, pred=pred)
        if self._tb is None:
            return path
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return path
        try:
            fig, axes = plt.subplots(3, 1, figsize=(10, 8))
            for ax, (data, title) in zip(axes, [(np.abs(pred - gt), "|pred - gt|"), (gt, "gt"), (pred, "pred")]):
                ax.imshow(data, origin="lower", aspect="auto", cmap="magma")
                ax.set_title(title)
            fig.tight_layout()
            self._tb.add_figure(tag, fig, step)
            plt.close(fig)
        except Exception:
            # the figure is best-effort (training goes on without it), but
            # its first failure is logged with the traceback
            if not self._figure_error_logged:
                self._figure_error_logged = True
                _log.exception("spec-comparison figure logging failed (logged once; figures disabled this run)")
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
