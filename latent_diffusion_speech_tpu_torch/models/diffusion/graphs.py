"""CUDA graphs of the eager denoiser evaluation, one per input shape.

An eager UNet forward is ~1400 kernel launches, and at serving shapes the
host's work to launch them takes longer than the device's work in them.
`DenoiserGraphs` runs `module(x, t)` from a `torch.cuda.CUDAGraph` kept per
(x.shape, x.dtype, t.shape, t.dtype, device): the same kernels in the same
order at the same precision, launched by one graph launch.

- The first evaluation of a new key runs eagerly on a side stream: the
  warm-up `torch.cuda.graphs` asks for, which makes lazy state (cuDNN
  plans, cuBLAS workspaces, shape-keyed caches) outside any capture.
- The second captures on that stream into static inputs that hold x and t,
  then replays.  Every later one copies x and t into the static inputs just
  before the replay and clones the output out just after it.
- Every graph of a device shares one memory pool: replays run one at a
  time on the caller's stream and each output is cloned before the next
  replay, so one graph's intermediates may lie where another's were.
- At most `MAX_KEYS` keys are kept, the least recently used dropped first,
  so inputs of many lengths cannot grow the cache without limit.
- A graph reads the parameters' storage: an in-place update (an optimizer
  step, `load_state_dict`) is what the next replay computes with.
  `check(module)` drops every graph once a parameter or buffer has moved to
  other storage.

Each evaluation counts one of `denoiser.graph_warmups`,
`denoiser.graph_captures` or `denoiser.graph_replays` in the port's tracer
(`utils/profiler.py`).  Python code inside the module runs at warm-up and
capture only, so its spans record there and not in replays.  The kernel
wrappers' launch counters (`ops/kernels/build.py::launch_counts`) count at
capture, and each replay adds what its capture counted, so they still count
the kernels that ran.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from latent_diffusion_speech_tpu_torch.ops.kernels import build
from latent_diffusion_speech_tpu_torch.utils import profiler

__all__ = ["DenoiserGraphs", "MAX_KEYS"]

# The keys serving makes: `TTSServer` batches up to 8 requests, padded to a
# power of two (1, 2, 4, 8), and `TTSPipeline.infer` pads lengths to 64-frame
# buckets, 16 of them up to the LM's 1024 frames; SVC's segments are B=1
# in the same buckets.  4 x 16 = 64 (a B=32 batch of 8 buckets fits too).
MAX_KEYS = 64


def _storage(module: nn.Module) -> Tuple[int, ...]:
    return tuple(p.data_ptr() for p in module.parameters()) + tuple(b.data_ptr() for b in module.buffers())


class _Graph:
    __slots__ = ("graph", "x", "t", "out", "launches")

    def __init__(self, graph: torch.cuda.CUDAGraph, x: torch.Tensor, t: torch.Tensor, out: torch.Tensor,
                 launches: Dict[Tuple[str, str], int]):
        self.graph, self.x, self.t, self.out, self.launches = graph, x, t, out, launches


class DenoiserGraphs:
    """`graphs(module, x, t)` is `module(x, t)` for CUDA tensors under
    `torch.no_grad`, from a CUDA graph from a key's second evaluation on
    (see the module's doc)."""

    def __init__(self):
        self._graphs: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()  # None: warmed up, not captured
        self._streams: Dict[torch.device, tuple] = {}  # device -> (side stream, memory pool)
        self._storage: Optional[Tuple[int, ...]] = None

    def __len__(self) -> int:
        """The graphs captured and kept."""
        return sum(g is not None for g in self._graphs.values())

    def check(self, module: nn.Module) -> None:
        """Drops every graph if `module`'s parameters or buffers no longer
        lie where the graphs read them."""
        if self._graphs and _storage(module) != self._storage:
            self._graphs.clear()

    def __call__(self, module: nn.Module, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), x.dtype, tuple(t.shape), t.dtype, x.device)
        if key not in self._graphs:
            if not self._graphs:
                self._storage = _storage(module)
            self._graphs[key] = None
            if len(self._graphs) > MAX_KEYS:
                self._graphs.popitem(last=False)
            profiler.count("denoiser.graph_warmups")
            return self._warm_up(module, x, t)
        self._graphs.move_to_end(key)
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = self._capture(module, x, t)
            profiler.count("denoiser.graph_captures")
        else:
            g.x.copy_(x)
            g.t.copy_(t)
            build.add_launches(g.launches)
            profiler.count("denoiser.graph_replays")
        g.graph.replay()
        return g.out.clone()

    def _side(self, device: torch.device) -> tuple:
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device), torch.cuda.graph_pool_handle())
        return self._streams[device]

    def _warm_up(self, module: nn.Module, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        side, _ = self._side(x.device)
        current = torch.cuda.current_stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = module(x, t)
        current.wait_stream(side)
        return out

    def _capture(self, module: nn.Module, x: torch.Tensor, t: torch.Tensor) -> _Graph:
        side, pool = self._side(x.device)
        graph, x, t = torch.cuda.CUDAGraph(), x.clone(), t.clone()
        before = build.launch_counts()
        # thread_local: another thread's allocations (a data loader's pinned
        # buffers) do not break the capture
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            out = module(x, t)
        launches = {k: n - before.get(k, 0) for k, n in build.launch_counts().items() if n != before.get(k, 0)}
        return _Graph(graph, x, t, out, launches)
