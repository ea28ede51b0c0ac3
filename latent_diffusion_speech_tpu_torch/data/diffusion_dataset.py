"""Diffusion training dataset over preprocessed npy dirs.

Counterpart of `latent_diffusion_speech_tpu/data/diffusion_dataset.py`,
with the same draws so both packages give the same items and batches from
the same files, seed and epoch:
* items keyed by `audio/<spk>/<name>.wav`; features read from sibling
  `mel/` and `units/` npy files;
* mel npy stores concat([m, logs]) (T, 2C); the latent is sampled
  z = m + eps * exp(logs) per read (or just m with only_mean), clamped;
* units re-timed to the mel frame grid (`units_forced_alignment`), then a
  random fixed-duration crop is taken;
* speaker ids are 1-based by directory order.
`fast_batch` is the native batched read (`data/native_loader.py`): the
cropped mel and units windows of a whole batch in one C++ call, the latent
sampled and the units aligned in numpy.  With `device_collate=True` it
returns the raw form instead, for the trainer to finish on the card:
`mel_stats` (B, F, 2C) f32, `units_raw` (B, U, C) at the units' own rate
in one static window U (`_u_fixed`) for every batch, `unit_idx` (B, F)
int32 (the nearest-alignment gather index into it), `spk_id`, `aug_shift`.
`transfer_dtype="bfloat16"` ships `units_raw` as bf16 bits in a uint16
array (numpy has no bfloat16; the trainer views them as `torch.bfloat16`).
The JAX package's options that its training entry point leaves at their
defaults are fixed here: no `aug_mel/` draw (`use_aug`), fixed-length
crops (no `whole_audio`) and seed 0.  Per-process sharding of the file
list is not ported (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from latent_diffusion_speech_tpu_torch.data.files import speaker_id_map, traverse_dir
from latent_diffusion_speech_tpu_torch.ops.alignment import units_forced_alignment

__all__ = ["DiffusionDataset", "bf16_bits"]


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
        device_collate: bool = False,
        transfer_dtype: Optional[str] = None,
    ):
        """device_collate: `fast_batch` returns the raw form; transfer_dtype:
        None (f32), "bfloat16" (uint16 bits) or a numpy dtype name for the
        raw form's `units_raw`."""
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
        self.device_collate = bool(device_collate)
        if transfer_dtype is not None and transfer_dtype != "bfloat16":
            transfer_dtype = np.dtype(transfer_dtype).name  # raises for an unknown name
        self.transfer_dtype = transfer_dtype
        if n_spk and n_spk > 1 and self.spk_map and max(self.spk_map.values()) > n_spk:
            raise ValueError("[x] spk_id must be a positive integer from 1 to n_spk")

    def __getstate__(self):
        """Picklable for the loader's process workers: the native reader is a
        ctypes handle, and each worker builds its own in `fast_batch`."""
        state = self.__dict__.copy()
        state.pop("_shared_reader", None)
        return state

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

    # -- native batched reads ---------------------------------------------------

    def _probe_all(self, reader) -> None:
        """Probe (mel_rows, C, unit_rows, unit_dim) of every path once; drop
        unusable files.  `_u_fixed` is the raw form's units window: one
        static shape for every batch."""
        self._probed = {}
        usable = []
        for p in self.paths:
            try:
                mel_rows, mel_row_bytes, _ = reader.probe(str(self.root / "mel" / p) + ".npy")
                unit_rows, unit_row_bytes, _ = reader.probe(str(self.root / "units" / p) + ".npy")
            except OSError:
                continue
            if mel_rows < self.frame_len + 2:
                continue
            self._probed[p] = (mel_rows, mel_row_bytes // 8, unit_rows, unit_row_bytes // 4)
            usable.append(p)
        self._fast_paths = usable
        self._u_fixed = max(
            (int(np.ceil((self.frame_len + 1) * u / m)) + 1 for (m, _, u, _) in self._probed.values()),
            default=0,
        )

    def _crops(self, indices):
        """(generators, names, mel starts) of a batch: each index keeps its
        own path; an unusable one is redrawn uniformly from the usable ones."""
        gs = [self._item_rng(i) for i in indices]
        names = [
            self.paths[i] if self.paths[i] in self._probed
            else self._fast_paths[int(g.integers(0, len(self._fast_paths)))]
            for i, g in zip(indices, gs)
        ]
        F = self.frame_len
        starts = [int(g.integers(0, max(self._probed[n][0] - F, 1))) for n, g in zip(names, gs)]
        return gs, names, starts

    def _spk_ids(self, names) -> np.ndarray:
        return np.array([[self.spk_map.get(str(Path(n).parent), 1) if self.spk_map else 1] for n in names],
                        np.int32)

    def fast_batch(self, indices, reader=None) -> Dict[str, np.ndarray]:
        """The batch of `indices` through the native reader (one is built on
        first use; a failed build raises).  Equal to the JAX package's
        `fast_batch` bit for bit, latent noise included; the raw form when
        `device_collate` is set.  A failed read raises OSError."""
        if reader is None:
            if not hasattr(self, "_shared_reader"):
                from latent_diffusion_speech_tpu_torch.data.native_loader import NativeNpyReader

                self._shared_reader = NativeNpyReader()
            reader = self._shared_reader
        if not hasattr(self, "_probed"):
            self._probe_all(reader)
        if not self._fast_paths:
            return self.batch(indices)
        if self.device_collate:
            return self._fast_batch_raw(indices, reader)

        F = self.frame_len
        gs, names, starts = self._crops(indices)
        mel_dim, unit_dim = self._probed[names[0]][1], self._probed[names[0]][3]
        count_u, metas = 0, []
        for name, s in zip(names, starts):
            mel_rows, _, unit_rows, _ = self._probed[name]
            ratio = unit_rows / mel_rows
            metas.append((s, mel_rows, unit_rows, ratio))
            count_u = max(count_u, int(np.ceil((F + 1) * ratio)) + 1)
        unit_starts = [min(int(np.floor(s * ratio)), max(unit_rows - count_u, 0))
                       for (s, _, unit_rows, ratio) in metas]

        stats = reader.read_batch([str(self.root / "mel" / n) + ".npy" for n in names], starts, F,
                                  (2 * mel_dim,))
        units_raw = reader.read_batch([str(self.root / "units" / n) + ".npy" for n in names], unit_starts,
                                      count_u, (unit_dim,))
        m, logs = stats[..., :mel_dim], stats[..., mel_dim:]
        if self.only_mean:
            mel = m
        else:
            noise = np.stack([g.standard_normal(m.shape[1:]) for g in gs]).astype(np.float32)
            mel = m + noise * np.exp(logs)
        if self.clamp and self.clamp > 0:
            mel = np.clip(mel, -self.clamp, self.clamp)

        # nearest alignment on the mel grid: global unit index floor(t * Tu / Tm)
        units = np.empty((len(names), F, unit_dim), np.float32)
        for b, (s, mel_rows, unit_rows, _) in enumerate(metas):
            t = np.arange(s, s + F)
            g = np.floor(t * (unit_rows / mel_rows)).astype(np.int64)
            units[b] = units_raw[b, np.clip(g - unit_starts[b], 0, count_u - 1)]
        return {
            "mel": mel,
            "units": units,
            "spk_id": self._spk_ids(names),
            "aug_shift": np.zeros((len(names), 1), np.float32),
        }

    def _fast_batch_raw(self, indices, reader) -> Dict[str, np.ndarray]:
        """The raw form: the host reads, the trainer samples the latent,
        aligns the units and clamps on the card."""
        F, U = self.frame_len, self._u_fixed
        _, names, starts = self._crops(indices)
        mel_dim, unit_dim = self._probed[names[0]][1], self._probed[names[0]][3]
        metas = []
        for name, s in zip(names, starts):
            mel_rows, _, unit_rows, _ = self._probed[name]
            metas.append((s, mel_rows, unit_rows, min(int(np.floor(s * unit_rows / mel_rows)), max(unit_rows - U, 0))))
        root = str(self.root)
        stats = reader.read_batch([f"{root}/mel/{n}.npy" for n in names], starts, F, (2 * mel_dim,))
        unit_paths = [f"{root}/units/{n}.npy" for n in names]
        unit_starts = [m[3] for m in metas]
        if self.transfer_dtype == "bfloat16" and hasattr(reader, "read_batch_bf16"):
            units_raw = reader.read_batch_bf16(unit_paths, unit_starts, U, (unit_dim,))
        else:
            units_raw = reader.read_batch(unit_paths, unit_starts, U, (unit_dim,))
            if self.transfer_dtype == "bfloat16":
                units_raw = bf16_bits(units_raw)
            elif self.transfer_dtype is not None:
                units_raw = units_raw.astype(self.transfer_dtype)

        t = np.arange(F)[None, :]
        s_arr = np.array([m[0] for m in metas])[:, None]
        ratio = np.array([m[2] / m[1] for m in metas])[:, None]
        u0 = np.array([m[3] for m in metas])[:, None]
        unit_idx = np.clip(np.floor((s_arr + t) * ratio).astype(np.int32) - u0, 0, U - 1).astype(np.int32)
        return {
            "mel_stats": stats,
            "units_raw": units_raw,
            "unit_idx": unit_idx,
            "spk_id": self._spk_ids(names),
            "aug_shift": np.zeros((len(names), 1), np.float32),
        }


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> bfloat16 bits as uint16: round to nearest even, every NaN the
    canonical quiet NaN of its sign, as the native reader's converting read
    and ml_dtypes' cast do (torch's CPU cast writes 0xFFFF for every NaN)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    out = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    out[nan] = np.where(u[nan] >> 31 != 0, np.uint16(0xFFC0), np.uint16(0x7FC0))
    return out
