"""Sharded checkpoints: one file a rank, for parameters split across ranks.

Counterpart of `latent_diffusion_speech_tpu/train/sharded_checkpoint.py`.
The single-file path (`train/checkpoint.py`) writes the whole state from
rank 0, which holds it all under data parallelism; under tensor or expert
parallelism no rank holds a split parameter whole.  Here, as in the JAX
package:

* **save**: every rank writes ONE `shard_p<k>.pt` holding exactly the
  chunks it owns: for each distinct chunk of a leaf, the lowest rank that
  holds it, so a chunk replicated over the data, seq or pipe axes (JAX's
  rules name neither of the last two) is written once.  Rank
  0 writes `index.json`, mapping every leaf of every tree (`params`,
  `opt_state`, `ema`) to its chunks, each with its global index ranges,
  plus `meta`.  A rank holds its own chunks only.
* **load**: each leaf is assembled from its chunks, one leaf at a time, and
  cut to the loader's chunk under the loader's layout (`shardings` and
  `mesh`), so a checkpoint saved under `model=2` restores onto one rank,
  onto `data=2` or onto another split.
* layout: `expdir/model_<step>.sharded/{index.json, shard_p*.pt}`, the same
  `model_<step>` step scan and retention as the single files
  (`train/checkpoint.py`).

The payload is the port's own format: `torch.save` of {chunk key: tensor}
(a host leaf, a Python number or a numpy array, as a tensor), read back
with `weights_only=True` and memory-mapped, so reading a leaf touches its
chunks only.  A leaf's spec (`parallel/sharding.py`: a mesh axis or None a
dimension) says how its tensor is split; the chunk a rank holds along a
split dimension is its coordinate's on that axis.

Collective discipline: `save_checkpoint_sharded` is called by EVERY rank
(the writes, then a barrier; rank 0 then applies retention, then a
barrier); `expdir` is storage every rank sees.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.parallel.dist import is_main_process, process_index, sync_global_devices
from latent_diffusion_speech_tpu_torch.parallel.mesh import AXES, Mesh, rank_coords
from latent_diffusion_speech_tpu_torch.parallel.sharding import global_shape, local_chunk
from latent_diffusion_speech_tpu_torch.train.checkpoint import apply_retention

__all__ = ["save_checkpoint_sharded", "load_checkpoint_sharded", "sharded_checkpoint_dir",
           "tree_needs_sharded_save"]

_INDEX = "index.json"
Trees = Dict[str, Optional[Dict[str, Any]]]
Specs = Dict[str, Dict[str, tuple]]


def sharded_checkpoint_dir(expdir: str | Path, step: int) -> Path:
    return Path(expdir) / f"model_{step}.sharded"


def tree_needs_sharded_save(shardings: Dict[str, tuple], mesh: Mesh) -> bool:
    """True when some leaf is split ACROSS processes (over a mesh axis above
    1 with a process group), not merely replicated over them."""
    if mesh is None or mesh.group is None:
        return False
    return any(a is not None and mesh.axis_size(a) > 1 for spec in shardings.values() for a in spec)


def _chunk(spec: tuple, coords: tuple) -> Tuple[int, ...]:
    """The chunk a rank at `coords` holds: its coordinate along each split dimension."""
    return tuple(coords[AXES.index(a)] if a is not None else 0 for a in spec)


def _owners(spec: tuple, mesh: Mesh, world: int) -> Dict[Tuple[int, ...], int]:
    """For each distinct chunk, the lowest rank that holds it: every rank
    computes the same map from the mesh, with no communication."""
    owners: Dict[Tuple[int, ...], int] = {}
    for r in range(world):
        owners.setdefault(_chunk(spec, rank_coords(r, mesh.spec)), r)
    return owners


def _ranges(chunk: Tuple[int, ...], spec: tuple, shape: Tuple[int, ...], mesh: Mesh) -> list:
    out = []
    for c, a, n in zip(chunk, spec, shape):
        size = mesh.axis_size(a) if a is not None else 1
        out.append([c * n // size, (c + 1) * n // size])
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _is_tensor_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def save_checkpoint_sharded(expdir: str | Path, step: int, trees: Trees, shardings: Specs, mesh: Mesh,
                            keep: int = 4, meta: Optional[dict] = None) -> Path:
    """Write `trees` ({"params": {name: tensor}, "opt_state": ..., "ema":
    ...}; a None tree is skipped) as a per-rank sharded checkpoint; each
    tree's leaves are this rank's chunks under `shardings[tree]` (a leaf
    not named there is whole).  Host leaves (Python numbers, numpy arrays)
    are rank 0's.  COLLECTIVE: call from every rank."""
    ckpt_dir = sharded_checkpoint_dir(expdir, step)
    if is_main_process():
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    sync_global_devices(f"sharded-ckpt-mkdir-{step}")

    me, world = process_index(), mesh.spec.total
    my_chunks: Dict[str, torch.Tensor] = {}
    index: Dict[str, Any] = {"step": step, "mesh": mesh.shape, "trees": {}, "meta": meta}
    for tree_name, tree in trees.items():
        if tree is None:
            continue
        leaves: Dict[str, Any] = {}
        specs = shardings.get(tree_name, {})
        for name, leaf in tree.items():
            if _is_tensor_leaf(leaf):
                spec = specs.get(name) or (None,) * leaf.dim()
                shape = global_shape(leaf.shape, spec, mesh)
                chunks = []
                mine = _chunk(spec, mesh.coords)
                for chunk, owner in sorted(_owners(spec, mesh, world).items()):
                    key = f"{tree_name}/{name}@{'.'.join(str(c) for c in chunk) or 'scalar'}"
                    chunks.append({"key": key, "file": f"shard_p{owner}.pt",
                                   "index": _ranges(chunk, spec, shape, mesh)})
                    if owner == me:
                        assert chunk == mine, (name, chunk, mine)
                        my_chunks[key] = leaf.detach().cpu().contiguous().clone()
                leaves[name] = {"shape": list(shape), "dtype": _dtype_name(leaf.dtype), "chunks": chunks}
            else:
                arr = np.asarray(leaf)
                key = f"{tree_name}/{name}@host"
                leaves[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                "chunks": [{"key": key, "file": "shard_p0.pt",
                                            "index": [[0, d] for d in arr.shape]}],
                                "host": True, "type": type(leaf).__name__}
                if me == 0:
                    my_chunks[key] = torch.from_numpy(np.ascontiguousarray(arr).copy())
        index["trees"][tree_name] = leaves

    torch.save(my_chunks, ckpt_dir / f"shard_p{me}.pt")
    if is_main_process():
        (ckpt_dir / _INDEX).write_text(json.dumps(index))
        if meta is not None:
            (Path(expdir) / f"model_{step}.meta.json").write_text(json.dumps(meta))
    # every shard written before anyone takes the checkpoint as complete
    sync_global_devices(f"sharded-ckpt-write-{step}")
    if keep and keep > 0 and is_main_process():
        apply_retention(Path(expdir), keep)
    sync_global_devices(f"sharded-ckpt-retain-{step}")
    return ckpt_dir


class _ChunkReader:
    """The shard files, each loaded once, memory-mapped."""

    def __init__(self, ckpt_dir: Path):
        self.dir = ckpt_dir
        self._files: Dict[str, Dict[str, torch.Tensor]] = {}

    def read(self, file: str, key: str) -> torch.Tensor:
        if file not in self._files:
            self._files[file] = torch.load(self.dir / file, map_location="cpu", weights_only=True, mmap=True)
        return self._files[file][key]


def _assemble(entry: dict, reader: _ChunkReader) -> torch.Tensor:
    shape = tuple(entry["shape"])
    first = reader.read(entry["chunks"][0]["file"], entry["chunks"][0]["key"])
    out = torch.empty(shape, dtype=first.dtype)
    for chunk in entry["chunks"]:
        idx = tuple(slice(a, b) for a, b in chunk["index"])
        out[idx] = reader.read(chunk["file"], chunk["key"]).reshape(tuple(b - a for a, b in chunk["index"]))
    return out


def load_checkpoint_sharded(expdir: str | Path, step: int, templates: Trees, shardings: Specs,
                            mesh: Mesh) -> Dict[str, Any]:
    """Restore `templates` ({tree: {name: this rank's tensor or a host
    value}}; a None tree comes back None) from the sharded checkpoint at
    `step`: each tensor leaf assembled whole from its chunks, then cut to
    this rank's chunk under `shardings[tree]` on `mesh` (on the CPU; the
    caller places it); host leaves come back as the template's type.
    Raises KeyError for a missing tree or leaves and ValueError for a
    global shape that differs from the template's.  One leaf's global
    tensor at a time."""
    ckpt_dir = sharded_checkpoint_dir(expdir, step)
    index = json.loads((ckpt_dir / _INDEX).read_text())
    reader = _ChunkReader(ckpt_dir)
    out: Dict[str, Any] = {}
    for tree_name, template in templates.items():
        if template is None:
            out[tree_name] = None
            continue
        leaves = index["trees"].get(tree_name)
        if leaves is None:
            raise KeyError(f"checkpoint has no tree '{tree_name}'")
        missing = [name for name in template if name not in leaves]
        if missing:
            raise KeyError(f"checkpoint tree '{tree_name}' is missing leaves: " + ", ".join(missing[:8]))
        specs = shardings.get(tree_name, {})
        restored = {}
        for name, leaf in template.items():
            whole = _assemble(leaves[name], reader)
            if _is_tensor_leaf(leaf):
                spec = specs.get(name) or (None,) * leaf.dim()
                want = global_shape(leaf.shape, spec, mesh)
                if tuple(whole.shape) != tuple(want):
                    raise ValueError(f"shape mismatch for {tree_name}/{name}: checkpoint {tuple(whole.shape)} "
                                     f"vs template {tuple(want)}")
                restored[name] = local_chunk(whole, spec, mesh).clone()
            elif isinstance(leaf, np.ndarray):
                restored[name] = whole.numpy().reshape(leaf.shape)
            else:
                restored[name] = type(leaf)(whole.item()) if whole.dim() == 0 else whole.numpy()
        out[tree_name] = restored
    return out
