"""Training metrics: a JSONL sink, a config snapshot, TensorBoard when it imports.

Counterpart of `latent_diffusion_speech_tpu/utils/logger.py::MetricsLogger`
for one process (the JAX package's rank-0 gate has nothing to gate here).
Scalars go to `<expdir>/logs/metrics.jsonl` (one JSON object a call) and, when
`torch.utils.tensorboard` imports, to TensorBoard; `config_snapshot` (a
`config_to_dict` dict) is written to `<expdir>/config.yaml`.  Validation audio
is written as 16-bit WAV files under `<expdir>/logs/audio/` (and to
TensorBoard when it is there), so it is kept on machines without TensorBoard.
The JAX logger's spectrogram figures (`log_spec_comparison`) are not ported.
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
        path = self.expdir / "logs" / "audio" / f"{re.sub(r'[^A-Za-z0-9_.-]', '_', tag)}_{step}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(path, audio, sample_rate)
        if self._tb is not None:
            self._tb.add_audio(tag, audio.reshape(-1, 1), step, sample_rate=sample_rate)
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
