"""A rank's local batch as its rows of the global batch, and the host copy
of the parameters.

Counterpart of `latent_diffusion_speech_tpu/parallel/multihost.py`.  Under
data parallelism each process loads only its slice of the data
(`paths[process_index::process_count]`, the reference's accelerate
striding), and the global batch is the ranks' local batches stitched in
rank order.  JAX stitches them into one global array
(`jax.make_array_from_process_local_data`), which requires every process's
local batch to have the same shape; here the rank keeps its rows as they
are, and `global_shard_batch` makes the same check with the same error
over the data axis's ranks.  The ranks that differ only along `seq`,
`model`, `pipe` or `expert` read their data coordinate's rows (JAX's second
layout, where those axes span processes and each loads the same batch):
the LM trainer cuts a token chunk (`seq`) or a microbatch's rows (`pipe`)
from them itself.  Parameters are replicated, so `gather_to_host` is a
local copy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["mesh_spans_processes", "global_shard_batch", "gather_to_host"]

_MAX_DIMS = 6


def gather_to_host(tree: Any) -> Any:
    """A host copy of a (nested dict / list of) tensor tree for a
    checkpoint: a local fetch, as every rank holds the replicated
    parameters (no collective)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    return tree


def mesh_spans_processes(mesh) -> bool:
    """True when `mesh` has more than one process on its data axis."""
    return mesh.group is not None and mesh.size > 1


def global_shard_batch(mesh, batch: dict) -> dict:
    """`batch` (this rank's local rows) as its part of the global batch:
    checks over the host group that every rank's arrays have the same
    shapes (the global batch is their concatenation in rank order) and
    returns the batch unchanged; raises JAX's ValueError otherwise."""
    if not mesh_spans_processes(mesh):
        return batch
    keys = sorted(batch)
    shapes = [tuple(np.shape(batch[k])) for k in keys]
    width = _MAX_DIMS + 1  # a shape as (ndim, its dims padded with -1)
    if any(len(s) > _MAX_DIMS for s in shapes):
        raise ValueError(f"global_shard_batch: arrays of more than {_MAX_DIMS} dims")
    everyone = mesh.host_gather([v for s in shapes for v in (len(s), *s, *[-1] * (_MAX_DIMS - len(s)))])
    for i, (k, s) in enumerate(zip(keys, shapes)):
        theirs = everyone[:, i * width:(i + 1) * width]
        if not (theirs == theirs[mesh.index]).all():
            raise ValueError(
                f"global_shard_batch: local batch shape {s} does not "
                f"tile the 'data' axis (size {mesh.size}) of the "
                f"multi-process mesh: {k!r} has shapes "
                f"{[tuple(int(d) for d in r[1:1 + r[0]]) for r in theirs]} across the ranks"
            )
    return batch
