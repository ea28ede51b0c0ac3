"""The mesh over the processes, its axes' process groups, and a batch's
rows on each.

Counterpart of `latent_diffusion_speech_tpu/parallel/mesh.py`.  The JAX
mesh has axes ("data", "seq", "model", "pipe", "expert") over devices, and
a train step over it is one global program.  Here a process drives one
device: `build_mesh` resolves `cfg.parallel` over the world of processes
with JAX's checks and messages (`resolve`; `data=-1` means every process
left), places rank r at JAX's device coordinate (the world's ranks
reshaped row-major into (data, seq, model, pipe, expert), as JAX reshapes
its device list) and returns a `Mesh`: this process's coordinates, a
process group for the data axis (`group`, with its gloo twin `host`) and
one for each set of axes a step reduces or splits over (`axis_group`):
the ranks that differ only along them.  `index` and `size` are the data
coordinate and the data axis's size: the ranks that differ only in `seq`,
`model`, `pipe` or `expert` hold the same rows.  Without a process group
the mesh is a world of one with no collectives; a world of one with a
group still runs every collective.

`dcn_data` (JAX's hybrid mesh across slices): each slice of
`n // dcn_data` processes is resolved on its own and the DCN factor is
outermost on `data`.  torchrun numbers ranks node by node, so slice k is
ranks [k n / dcn_data, (k + 1) n / dcn_data), and rank r's coordinate is
still the row-major one, as JAX's `create_hybrid_device_mesh` lays out
devices that carry no physical topology.

A step over the mesh gives what the global program gives when:
* each rank holds its rows of the global batch, data coordinate d's rows
  before d + 1's (`shard_batch` cuts them from a global batch;
  `multihost.global_shard_batch` takes a rank's own rows as they are);
* every random draw is made for the global batch and each rank keeps its
  rows (`RowGenerator` with `randn`, `rand` and `randint`; under `seq` its
  token chunk too), so a world of N draws what a world of one draws for
  the same global batch, and the ranks of one model group draw the same
  numbers;
* the gradients are averaged over the data axis (`all_reduce_mean_`, one
  coalesced collective) and summed over the axes whose ranks each hold a
  share of one data coordinate's loss (`seq`: its token chunk; `pipe`:
  its stage), and whatever the loss takes over the batch beyond a mean of
  equal parts is reduced before it is used;
* the parameters split over `model` and `expert` (`parallel/sharding.py`)
  run their partitioned products with the collectives of
  `parallel/tensor.py` over `axis_group`;
* self-attention over a `seq` chunk runs the ring (`ops/ring_attention.py`)
  and the layer stack over `pipe` runs GPipe (`parallel/pipeline.py`),
  both over P2P between the ranks `peer` names.

Not ported, as they have no meaning without a sharded array type:
`batch_sharding`, `replicated` and `with_sharding` (a rank's tensors are
its rows and its chunks).
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

__all__ = ["MeshSpec", "Mesh", "build_mesh", "resolve", "shard_batch", "RowGenerator", "randn", "rand", "randint"]

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


def resolve(cfg: ParallelConfig, n_devices: int) -> MeshSpec:
    """The geometry of `cfg` over `n_devices` processes; with `dcn_data`
    above 1 each slice of `n_devices // dcn_data` is resolved on its own
    (JAX's `_resolve_spec(cfg, per_slice)`) and the slices stack on
    `data`."""
    dcn = max(1, getattr(cfg, "dcn_data", 1))
    if dcn == 1:
        return _resolve_spec(cfg, n_devices)
    if n_devices % dcn != 0:
        raise ValueError(f"mesh: {n_devices} devices not divisible by dcn_data({dcn})")
    inner = _resolve_spec(cfg, n_devices // dcn)
    return dataclasses.replace(inner, data=dcn * inner.data)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh over the processes: `spec`, this process's coordinate `index`
    on the data axis, `group` (the data axis's process group, whose backend
    matches the devices) and `host` (a gloo group over the same ranks, for
    host integers); both None for a single process without a group.
    `coords` is this rank's coordinate on every axis (`AXES` order) and
    `groups` maps a tuple of axes above 1 (`AXES` order) to the process
    group of the ranks that differ only along them."""

    spec: MeshSpec
    index: int = 0
    group: Any = None
    host: Any = None
    coords: tuple = (0, 0, 0, 0, 0)
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.spec.data, self.spec.seq, self.spec.model, self.spec.pipe, self.spec.expert)))

    @property
    def size(self) -> int:
        """The data axis's size: the ranks that hold rows of the batch."""
        return self.spec.data

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def coordinate(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[AXES.index(axis)]

    @property
    def model_parallel(self) -> bool:
        """True when parameters can be split: a `model` or `expert` axis above 1."""
        return self.spec.model > 1 or self.spec.expert > 1

    def axis_group(self, axes) -> Any:
        """The process group over `axes` (any of `AXES`, order free): the
        ranks that differ only along them, in rank order (row-major over
        the axes); None without a process group or when those axes are all
        of size 1, except that axes with `data` whose others are all 1 give
        `group` (so a world of one with a group still runs the data axis's
        collectives)."""
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if AXIS_DATA in axes and key in ((), (AXIS_DATA,)):
            return self.group
        return self.groups.get(key) if key else None

    def peer(self, axis: str, coordinate: int) -> int:
        """The global rank at this rank's coordinates with `axis` at
        `coordinate` (a P2P partner)."""
        coords = list(self.coords)
        coords[AXES.index(axis)] = coordinate
        shape = (self.spec.data, self.spec.seq, self.spec.model, self.spec.pipe, self.spec.expert)
        return int(np.ravel_multi_index(tuple(coords), shape))

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of `n_local` rows a rank."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor], over: Sequence[str] = (AXIS_DATA,)) -> None:
        """Sum `tensors` in place over the group of `over` and divide by the
        data axis's size: the mean over the data axis of shares summed over
        the other axes of `over` (one all-reduce of one flat buffer a dtype;
        no-op without a group)."""
        self._all_reduce_(tensors, over, mean=True)

    def all_reduce_sum_(self, tensors: Sequence[torch.Tensor], over: Sequence[str] = (AXIS_DATA,)) -> None:
        """Sum `tensors` over the group of `over` in place, one flat buffer a dtype."""
        self._all_reduce_(tensors, over, mean=False)

    def _all_reduce_(self, tensors: Sequence[torch.Tensor], over: Sequence[str], mean: bool) -> None:
        group = self.axis_group(over)
        if self.group is None or group is None:
            return
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = _flatten_dense_tensors(same)
            dist.all_reduce(flat, group=group)
            if mean:
                flat.div_(self.size)
            torch._foreach_copy_(same, list(_unflatten_dense_tensors(flat, same)))

    def all_gather(self, t: torch.Tensor, over: Sequence[str] = (AXIS_DATA,)) -> torch.Tensor:
        """(n, *t.shape): the `t` of every rank of the group of `over`, in
        rank order (t itself, unsqueezed, without one)."""
        group = self.axis_group(over)
        if self.group is None or group is None:
            return t[None]
        out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t.contiguous(), group=group)
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


def rank_coords(rank: int, spec: MeshSpec) -> tuple:
    """Rank `rank`'s coordinate on every axis: the world's ranks reshaped
    row-major into (data, seq, model, pipe, expert), JAX's device order."""
    shape = (spec.data, spec.seq, spec.model, spec.pipe, spec.expert)
    return tuple(int(c) for c in np.unravel_index(rank, shape))


def _axis_groups(spec: MeshSpec, me: int, axes: tuple, backend: Optional[str] = None):
    """The process group of this rank over `axes`: one `new_group` a
    distinct group, made on every rank in the same order (as
    `torch.distributed` requires), then one collective over it: NCCL
    leaves P2P between some of a group's ranks undefined until all of them
    have communicated (the pipeline's first tick involves two stages)."""
    idx = [AXES.index(a) for a in axes]
    by_rest: dict = {}
    for r in range(spec.total):
        c = rank_coords(r, spec)
        by_rest.setdefault(tuple(v for i, v in enumerate(c) if i not in idx), []).append(r)
    mine = None
    for ranks in by_rest.values():
        g = dist.new_group(ranks, backend=backend)
        if me in ranks:
            mine = g
    on_card = dist.get_backend(mine) == "nccl"
    dist.all_reduce(torch.zeros(1, device=pdist.rank_device() if on_card else "cpu"), group=mine)
    return mine


def _group_axes(spec: MeshSpec) -> list:
    """The sets of axes (above 1, `AXES` order) a step needs a group over
    besides `data`: each split axis and both together (tensor and expert
    parallelism); `seq` alone (the ring) and with `data` (the MoE's token
    order); `pipe` alone (the pipeline); the axes whose ranks hold shares
    of one loss with `data` (the LM's gradient reduction)."""
    big = {a for a, n in zip(AXES, (spec.data, spec.seq, spec.model, spec.pipe, spec.expert)) if n > 1}
    wanted = [(a,) for a in (AXIS_SEQ, AXIS_MODEL, AXIS_PIPE, AXIS_EXPERT) if a in big]
    wanted.append((AXIS_MODEL, AXIS_EXPERT))
    wanted.append((AXIS_DATA, AXIS_SEQ))
    wanted.append((AXIS_DATA, AXIS_SEQ, AXIS_PIPE))
    out = []
    for axes in wanted:
        key = tuple(a for a in axes if a in big)
        if len(key) > 0 and key != (AXIS_DATA,) and key not in out:
            out.append(key)
    return out


def build_mesh(cfg: Optional[ParallelConfig] = None) -> Mesh:
    """The mesh of `cfg` (default: every process on the data axis) over the
    world of processes; a single process without a group is a world of one
    with no collectives.  Serves all five axes and `dcn_data`; raises JAX's
    ValueError when the axes do not fit the world.  Under a group every
    rank must call it, at the same point."""
    cfg = cfg or ParallelConfig()
    spec = resolve(cfg, pdist.process_count())
    if not dist.is_initialized():
        return Mesh(spec)
    me = dist.get_rank()
    coords = rank_coords(me, spec)
    if spec.data == spec.total:  # data parallelism alone: the world is the data group
        group, host = dist.group.WORLD, pdist.host_group()
    else:
        group = _axis_groups(spec, me, (AXIS_DATA,))
        host = group if dist.get_backend() == "gloo" else _axis_groups(spec, me, (AXIS_DATA,), "gloo")
    groups = {axes: _axis_groups(spec, me, axes) for axes in _group_axes(spec)}
    return Mesh(spec, index=coords[0], group=group, host=host, coords=coords, groups=groups)


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
    the ranks together draw what one process draws for the whole batch.
    `tokens` (sequence parallelism): dimension 1 of every draw is the token
    dimension, drawn for the whole sequence (times the `seq` axis's size)
    and cut to this rank's chunk.  A rank draws the whole batch's numbers
    for each draw: memory and time a world's worth of that draw.  Through
    these functions a CPU generator also serves a step on the card: it
    draws on the host, so a card's step draws what a CPU process's
    draws."""

    def __init__(self, generator: torch.Generator, mesh: Mesh, tokens: bool = False):
        self.generator, self.mesh = generator, mesh
        self.tokens = tokens and mesh.spec.seq > 1


def _on_host(fn, shape, generator, **kwargs) -> torch.Tensor:
    """fn's draw; a CPU generator asked for another device draws on the
    host and the numbers move there (the same numbers as on the CPU)."""
    device = kwargs.get("device")
    if generator is not None and generator.device.type == "cpu" and device is not None \
            and torch.device(device).type != "cpu":
        return fn(shape, generator=generator, **{**kwargs, "device": "cpu"}).to(device)
    return fn(shape, generator=generator, **kwargs)


def _draw(fn, shape, generator, **kwargs) -> torch.Tensor:
    if not isinstance(generator, RowGenerator):
        return _on_host(fn, tuple(shape), generator, **kwargs)
    mesh = generator.mesh
    shape = tuple(shape)
    if not generator.tokens:
        whole = _on_host(fn, (shape[0] * mesh.size,) + shape[1:], generator.generator, **kwargs)
        return whole[mesh.rows(shape[0])]
    n, t = mesh.spec.seq, shape[1]
    whole = _on_host(fn, (shape[0] * mesh.size, t * n) + shape[2:], generator.generator, **kwargs)
    return whole[mesh.rows(shape[0])].narrow(1, mesh.coordinate(AXIS_SEQ) * t, t)


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
