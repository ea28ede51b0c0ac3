"""Diffusion training dataset over preprocessed npy dirs (host path).

Counterpart of `latent_diffusion_speech_tpu/data/diffusion_dataset.py`,
its host-collated path (`__getitem__`, `_get`, `batch`), with the same
draws so both packages give the same items from the same files, seed and
epoch:
* items keyed by `audio/<spk>/<name>.wav`; features read from sibling
  `mel/` and `units/` npy files;
* mel npy stores concat([m, logs]) (T, 2C); the latent is sampled
  z = m + eps * exp(logs) per read (or just m with only_mean), clamped;
* units re-timed to the mel frame grid (`units_forced_alignment`), then a
  random fixed-duration crop is taken;
* speaker ids are 1-based by directory order.
The JAX package's options that its training entry point leaves at their
defaults are fixed here: no `aug_mel/` draw (`use_aug`), fixed-length
crops (no `whole_audio`) and seed 0.  Its native batched reader
(`fast_batch`), device-side collation and per-process sharding of the file
list are not ported (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from latent_diffusion_speech_tpu_torch.data.files import speaker_id_map, traverse_dir
from latent_diffusion_speech_tpu_torch.ops.alignment import units_forced_alignment

__all__ = ["DiffusionDataset"]


class DiffusionDataset:
    # items draw only from per-call (seed, epoch, index)-keyed generators:
    # safe for the loader's threaded item assembly
    thread_safe_items = True

    def __init__(
        self,
        path_root: str | Path,
        waveform_sec: float = 1.0,
        hop_size: int = 512,
        sample_rate: int = 44100,
        extensions=("wav",),
        n_spk: int = 1,
        units_forced_mode: str = "nearest",
        only_mean: bool = False,
        clamp: float = 10.0,
        cache: bool = False,
    ):
        self.root = Path(path_root)
        self.frame_len = int(waveform_sec * sample_rate / hop_size)
        self.units_forced_mode = units_forced_mode
        self.only_mean = only_mean
        self.clamp = clamp

        self.paths = traverse_dir(self.root / "audio", extensions=extensions)
        self.spk_map = speaker_id_map(self.paths) if (n_spk and n_spk > 1) else {}
        # per-item draws are keyed on (seed 0, epoch, index): set_epoch and
        # the loader's epoch-keyed shuffle make the stream reproducible
        self.epoch = 0
        self._cache: Optional[Dict] = {} if cache else None
        if n_spk and n_spk > 1 and self.spk_map and max(self.spk_map.values()) > n_spk:
            raise ValueError("[x] spk_id must be a positive integer from 1 to n_spk")

    def __len__(self) -> int:
        return len(self.paths)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _item_rng(self, idx) -> np.random.Generator:
        return np.random.default_rng([0, self.epoch, int(idx)])

    def _load(self, name_ext: str, kind: str) -> np.ndarray:
        if self._cache is not None and (name_ext, kind) in self._cache:
            return self._cache[(name_ext, kind)]
        arr = np.load(str(self.root / kind / name_ext) + ".npy")
        if self._cache is not None:
            self._cache[(name_ext, kind)] = arr
        return arr

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        g = self._item_rng(idx)
        for attempt in range(len(self.paths)):
            name_ext = self.paths[(idx + attempt) % len(self.paths)]
            try:
                item = self._get(name_ext, g)
                if item is not None:
                    return item
            except (OSError, ValueError, KeyError):
                continue
        raise RuntimeError("diffusion dataset: no loadable item found")

    def _get(self, name_ext: str, g: np.random.Generator) -> Optional[Dict[str, np.ndarray]]:
        stats = self._load(name_ext, "mel").astype(np.float32)  # (T, 2C)
        T = stats.shape[0]
        C = stats.shape[1] // 2
        m, logs = stats[:, :C], stats[:, C:]
        if self.only_mean:
            mel = m
        else:
            mel = m + g.standard_normal(m.shape).astype(np.float32) * np.exp(logs)
        if self.clamp and self.clamp > 0:
            mel = np.clip(mel, -self.clamp, self.clamp)

        units = self._load(name_ext, "units").astype(np.float32)
        units = units_forced_alignment(units, n_frames=T, mode=self.units_forced_mode)

        frame_len = self.frame_len
        if T < frame_len + 2:
            return None  # too short; the caller advances
        start = int(g.integers(0, max(T - frame_len, 1)))
        mel = mel[start : start + frame_len]
        units = units[start : start + frame_len]

        spk_id = self.spk_map.get(str(Path(name_ext).parent), 1) if self.spk_map else 1
        return {
            "mel": mel,
            "units": units,
            "spk_id": np.array([spk_id], np.int32),
            "aug_shift": np.array([0.0], np.float32),
        }

    def batch(self, indices) -> Dict[str, np.ndarray]:
        items = [self[i] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
