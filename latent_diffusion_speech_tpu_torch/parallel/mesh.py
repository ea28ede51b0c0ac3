"""The mesh over the processes, and a batch's rows on each.

Counterpart of `latent_diffusion_speech_tpu/parallel/mesh.py`.  The JAX
mesh has axes ("data", "seq", "model", "pipe", "expert") over devices, and
a train step over it is one global program.  Here a process drives one
device, and only the `data` axis is served: `build_mesh` resolves
`cfg.parallel` over the world of processes with JAX's checks and messages
(`_resolve_spec`; `data=-1` means every process) and returns a `Mesh`:
this process's coordinate on the data axis and the process groups its
collectives run on (none for a single process without a group; a world of
one with a group still runs every collective).

A step over the mesh gives what the global program gives when:
* each rank holds its rows of the global batch, rank r's rows before rank
  r + 1's (`shard_batch` cuts them from a global batch;
  `multihost.global_shard_batch` takes a rank's own rows as they are);
* every random draw is made for the global batch and each rank keeps its
  rows (`RowGenerator` with `randn`, `rand` and `randint`), so a world of N
  draws what a world of one draws for the same global batch;
* the gradients are averaged over the ranks (`all_reduce_mean_`, one
  coalesced collective), and whatever the loss takes over the batch beyond
  a mean of equal parts is reduced before it is used.

Not ported, as they have no meaning without a sharded array type:
`batch_sharding`, `replicated` and `with_sharding` (a rank's tensors are
its rows, parameters are replicated by construction), and the `dcn_data`
hybrid layout, which raises with the other axes (ROADMAP.md Queue 1,
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from latent_diffusion_speech_tpu_torch.config import ParallelConfig
from latent_diffusion_speech_tpu_torch.parallel import dist as pdist

__all__ = ["MeshSpec", "Mesh", "build_mesh", "shard_batch", "RowGenerator", "randn", "rand", "randint"]

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXES = (AXIS_DATA, AXIS_SEQ, AXIS_MODEL, AXIS_PIPE, AXIS_EXPERT)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Resolved mesh geometry: (data, seq, model, pipe, expert) axis sizes."""

    data: int
    seq: int
    model: int
    pipe: int = 1
    expert: int = 1

    @property
    def total(self) -> int:
        return self.data * self.seq * self.model * self.pipe * self.expert


def _resolve_spec(cfg: ParallelConfig, n_devices: int) -> MeshSpec:
    model = max(1, cfg.model)
    seq = max(1, cfg.seq)
    pipe = max(1, getattr(cfg, "pipe", 1))
    expert = max(1, getattr(cfg, "expert", 1))
    denom = model * seq * pipe * expert
    if n_devices % denom != 0:
        raise ValueError(
            f"mesh: {n_devices} devices not divisible by "
            f"model({model})*seq({seq})*pipe({pipe})*expert({expert})"
        )
    data = cfg.data if cfg.data > 0 else n_devices // denom
    if data * denom != n_devices:
        raise ValueError(
            f"mesh: data({data})*seq({seq})*model({model})*pipe({pipe})"
            f"*expert({expert}) != devices({n_devices})"
        )
    return MeshSpec(data=data, seq=seq, model=model, pipe=pipe, expert=expert)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh: `spec` (only `data` above 1), this process's
    coordinate `index` on the data axis, `group` (the default process group,
    whose backend matches the devices) and `host` (a gloo group for host
    integers); both None for a single process without a group."""

    spec: MeshSpec
    index: int = 0
    group: Any = None
    host: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.spec.data, self.spec.seq, self.spec.model, self.spec.pipe, self.spec.expert)))

    @property
    def size(self) -> int:
        """The data axis's size: the ranks that hold rows of the batch."""
        return self.spec.data

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of `n_local` rows a rank."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average `tensors` over the ranks in place: one all-reduce of one
        flat buffer a dtype (no-op without a group)."""
        self._all_reduce_(tensors, mean=True)

    def all_reduce_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum `tensors` over the ranks in place, one flat buffer a dtype."""
        self._all_reduce_(tensors, mean=False)

    def _all_reduce_(self, tensors: Sequence[torch.Tensor], mean: bool) -> None:
        if self.group is None:
            return
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = _flatten_dense_tensors(same)
            dist.all_reduce(flat, group=self.group)
            if mean:
                flat.div_(self.size)
            torch._foreach_copy_(same, list(_unflatten_dense_tensors(flat, same)))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's `t` in rank order (t itself,
        unsqueezed, without a group)."""
        if self.group is None:
            return t[None]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def host_gather(self, values: Sequence[int]) -> np.ndarray:
        """(size, len(values)) int64: every rank's host integers in rank
        order, over the gloo group (no device sync)."""
        mine = torch.tensor(list(values), dtype=torch.int64)
        if self.host is None:
            return mine[None].numpy()
        out = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(out, mine, group=self.host)
        return torch.stack(out).numpy()


def build_mesh(cfg: Optional[ParallelConfig] = None) -> Mesh:
    """The mesh of `cfg` (default: every process on the data axis) over the
    world of processes; a single process without a group is a world of one
    with no collectives.  Raises NotImplementedError for an axis other than
    `data` above 1, and JAX's ValueError when the axes do not fit the world."""
    cfg = cfg or ParallelConfig()
    other = {k: getattr(cfg, k) for k in ("model", "seq", "pipe", "expert", "dcn_data") if getattr(cfg, k) > 1}
    if other:
        raise NotImplementedError(f"parallel {other}: only data parallelism is ported; tensor, sequence, "
                                  "pipeline, expert and multi-slice parallelism are not (ROADMAP.md Queue 1, "
                                  "item 10)")
    spec = _resolve_spec(cfg, pdist.process_count())
    if not dist.is_initialized():
        return Mesh(spec)
    return Mesh(spec, index=dist.get_rank(), group=dist.group.WORLD, host=pdist.host_group())


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of a global host batch (a dict of arrays or
    tensors): rank r keeps rows [r n, (r + 1) n) of each leading dimension
    that the data axis divides; the others (scalars, ragged evaluation
    batches) are kept whole, as JAX replicates them."""

    def cut(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % mesh.size == 0:
            return x[mesh.rows(x.shape[0] // mesh.size)]
        return x

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return cut(batch)


class RowGenerator:
    """A step's generator under data parallelism: each draw made through
    `randn`, `rand` or `randint` is drawn for the global batch (the leading
    dimension times the data axis's size) and this rank keeps its rows, so
    the ranks together draw what one process draws for the whole batch.  A
    rank draws the whole batch's numbers for each draw: memory and time a
    world's worth of that draw."""

    def __init__(self, generator: torch.Generator, mesh: Mesh):
        self.generator, self.mesh = generator, mesh


def _draw(fn, shape, generator, **kwargs) -> torch.Tensor:
    if not isinstance(generator, RowGenerator):
        return fn(tuple(shape), generator=generator, **kwargs)
    mesh = generator.mesh
    shape = tuple(shape)
    whole = fn((shape[0] * mesh.size,) + shape[1:], generator=generator.generator, **kwargs)
    return whole[mesh.rows(shape[0])]


def randn(shape, generator, **kwargs) -> torch.Tensor:
    """`torch.randn(shape, generator=...)`, by rows under a `RowGenerator`."""
    return _draw(torch.randn, shape, generator, **kwargs)


def rand(shape, generator, **kwargs) -> torch.Tensor:
    """`torch.rand(shape, generator=...)`, by rows under a `RowGenerator`."""
    return _draw(torch.rand, shape, generator, **kwargs)


def randint(low: int, high: int, shape, generator, **kwargs) -> torch.Tensor:
    """`torch.randint(low, high, shape, generator=...)`, by rows under a
    `RowGenerator`."""
    return _draw(lambda s, **kw: torch.randint(low, high, s, **kw), shape, generator, **kwargs)
