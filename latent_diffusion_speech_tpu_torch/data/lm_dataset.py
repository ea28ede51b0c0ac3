"""LM training dataset over `utt/` + `semantic_token/` npy dirs.

A copy of `latent_diffusion_speech_tpu/data/lm_dataset.py` (its RoFormer
part): items pair `(phones, tones, lang_ids, word2ph)` from `utt/` (stage 16)
with token ids from `semantic_token/` (stage 19); semantic sequences are
BOS/EOS-wrapped; speaker ids are per-token sequences; the collate pads to
pad-to-multiple buckets with -100 labels on the padding; `collate_llama_batch`
is the Llama LM's single-stream collate.

Imports numpy only (no torch): the loader's spawn workers unpickle this
module's dataset and collate, and start in well under a second.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from latent_diffusion_speech_tpu_torch.data.files import speaker_id_map, traverse_dir

__all__ = ["TextDataset", "collate_text_batch", "collate_llama_batch"]


class TextDataset:
    thread_safe_items = True  # items are pure functions of the files on disk

    def __init__(
        self,
        path_root: str | Path,
        semantic_bos: int,
        semantic_eos: int,
        n_spk: int = 1,
        process_index: int = 0,
        process_count: int = 1,
        cache: bool = False,
    ):
        self.root = Path(path_root)
        self.semantic_bos = semantic_bos
        self.semantic_eos = semantic_eos
        self.n_spk = n_spk
        all_paths = traverse_dir(self.root / "utt", extensions=("npy",))
        self.spk_map = speaker_id_map(all_paths) if (n_spk and n_spk > 1) else {}
        self.paths = all_paths[process_index::process_count]
        self._cache: Optional[Dict] = {} if cache else None
        self._item_lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.paths)

    def item_lengths(self) -> np.ndarray:
        """Per-item semantic length (with BOS/EOS) from the npy headers only,
        for the loader's length-sorted batching.  Cached in the sidecar
        `semantic_token/.lengths_cache.npz`, keyed on the path list and the
        files' sizes (the JAX package's key, so either package reads the
        other's sidecar); the cache is best-effort."""
        if self._item_lengths is not None:
            return self._item_lengths
        cache = self.root / "semantic_token" / ".lengths_cache.npz"
        key = None
        try:
            sizes = np.array([(self.root / "semantic_token" / n).stat().st_size for n in self.paths], np.int64)
            h = hashlib.sha256("\n".join(self.paths).encode())
            h.update(sizes.tobytes())
            key = h.hexdigest()
            if cache.exists():
                z = np.load(cache, allow_pickle=False)
                if str(z.get("key")) == key and len(z["lens"]) == len(self.paths):
                    self._item_lengths = z["lens"].astype(np.int64)
                    return self._item_lengths
        except (OSError, ValueError, KeyError):
            pass  # the cache is an optimisation only
        lens = np.empty(len(self.paths), np.int64)
        for i, name in enumerate(self.paths):
            try:
                with open(self.root / "semantic_token" / name, "rb") as f:
                    version = np.lib.format.read_magic(f)
                    if version >= (2, 0):
                        shape, _, _ = np.lib.format.read_array_header_2_0(f)
                    else:
                        shape, _, _ = np.lib.format.read_array_header_1_0(f)
                lens[i] = shape[0] + 2  # + BOS/EOS
            except (OSError, ValueError):
                lens[i] = 0  # unloadable items are substituted at __getitem__
        self._item_lengths = lens
        if key is not None:
            try:
                np.savez(cache, key=key, lens=lens)
            except OSError:
                pass
        return self._item_lengths

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for attempt in range(len(self.paths)):
            name = self.paths[(idx + attempt) % len(self.paths)]
            try:
                return self._get(name)
            except (OSError, ValueError, KeyError):
                continue
        raise RuntimeError("text dataset: no loadable item found")

    def _get(self, name: str) -> Dict[str, np.ndarray]:
        if self._cache is not None and name in self._cache:
            return self._cache[name]
        phones, tones, _lang_ids, _word2ph = np.load(self.root / "utt" / name, allow_pickle=True)
        semantic = np.load(self.root / "semantic_token" / name)
        semantic = np.concatenate([[self.semantic_bos], semantic, [self.semantic_eos]])
        phones = np.asarray(phones, np.int32)
        tones = np.asarray(tones, np.int32) if len(np.atleast_1d(tones)) else np.zeros_like(phones)
        spk = self.spk_map.get(str(Path(name).parent), 1) if self.spk_map else 1
        item = {
            "phone": phones,
            "tone": tones,
            "semantic": np.asarray(semantic, np.int32),
            "spk_id": np.full_like(phones, spk),
        }
        if self._cache is not None:
            self._cache[name] = item
        return item


def _pad_to(arr: np.ndarray, length: int, value) -> np.ndarray:
    out = np.full((length,), value, arr.dtype)
    out[: len(arr)] = arr[:length]
    return out


def collate_text_batch(
    items: List[Dict[str, np.ndarray]],
    phone_pad: int,
    semantic_pad: int,
    pad_multiple: int = 32,
    max_phone_len: Optional[int] = None,
    max_semantic_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pad to bucketed lengths (the next multiple of `pad_multiple`); labels
    are -100 on the padding (the HF ignore index)."""

    def bucket(n):
        return max(pad_multiple, -(-n // pad_multiple) * pad_multiple)

    pl = max_phone_len or bucket(max(len(it["phone"]) for it in items))
    sl = max_semantic_len or bucket(max(len(it["semantic"]) for it in items))
    return {
        "phone": np.stack([_pad_to(it["phone"], pl, phone_pad) for it in items]),
        "tone": np.stack([_pad_to(it["tone"], pl, 0) for it in items]),
        "semantic": np.stack([_pad_to(it["semantic"], sl, semantic_pad) for it in items]),
        "labels": np.stack([_pad_to(it["semantic"].astype(np.int32), sl, -100) for it in items]),
        "encoder_attention_mask": np.stack([_pad_to(np.ones(len(it["phone"]), np.int32), pl, 0) for it in items]),
        "attention_mask": np.stack([_pad_to(np.ones(len(it["semantic"]), np.int32), sl, 0) for it in items]),
        "spk_id": np.stack([_pad_to(it["spk_id"], pl, 0) for it in items]),
    }


def collate_llama_batch(
    items: List[Dict[str, np.ndarray]],
    token_shift: int,
    phone_bos: int,
    phone_eos: int,
    pad_id: int,
    pad_multiple: int = 32,
    max_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Single-stream Llama collate: each item becomes

        input_ids = [BOS, phones, EOS] ++ (semantic_wrapped + token_shift)

    where the dataset already wrapped semantic with the unshifted BOS/EOS
    (kmeans_num, kmeans_num + 1), which shift onto Llama's semantic BOS/EOS.
    labels = input_ids with -100 on the padding (the CE covers the phone
    prompt too); input_ids are padded with `pad_id`, to one length that is a
    multiple of `pad_multiple` (or `max_len`)."""

    def bucket(n):
        return max(pad_multiple, ((n + pad_multiple - 1) // pad_multiple) * pad_multiple)

    seqs = [np.concatenate([[phone_bos], it["phone"], [phone_eos], it["semantic"] + token_shift]).astype(np.int32)
            for it in items]
    L = max_len or bucket(max(len(s) for s in seqs))
    return {
        "input_ids": np.stack([_pad_to(s, L, pad_id) for s in seqs]),
        "labels": np.stack([_pad_to(s, L, -100) for s in seqs]),
        "attention_mask": np.stack([_pad_to(np.ones(len(s), np.int32), L, 0) for s in seqs]),
    }
