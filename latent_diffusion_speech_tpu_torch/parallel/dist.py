"""Multi-process runtime: init, rank queries, barriers.

Counterpart of `latent_diffusion_speech_tpu/parallel/dist.py` on
`torch.distributed` (the reference's accelerate surface: `Accelerator()`,
`is_main_process`, `wait_for_everyone()`, `process_index/num_processes`).
`torchrun --nproc_per_node=N` starts one process a device and sets `RANK`,
`WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT` and `LOCAL_RANK`;
`initialize_distributed` joins the default process group from them, NCCL
when the rank's device is a card and gloo when it is the CPU, as the caller
asks for it (never by probing for a card).  Without that environment it is
a no-op and the program runs as one process, as JAX's does without a
coordinator.

`host_group()` is a gloo group over the same processes for host-side
metadata (batch shapes, token counts): it exchanges Python integers without
waiting for the device.  `exchange` is one step of point-to-point traffic
(the ring's and the pipeline's): a send and a receive posted together.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed",
    "process_index",
    "process_count",
    "is_main_process",
    "sync_global_devices",
    "local_device_count",
    "rank_device",
    "host_group",
    "shutdown_distributed",
    "exchange",
]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_host_group = None


def rank_device(device=None) -> torch.device:
    """The device this process drives: `cuda:LOCAL_RANK` unless the caller
    asks for another (`"cpu"`, or an explicit `cuda:i`); `None` and `"cuda"`
    mean the card of this local rank."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize_distributed(device=None) -> bool:
    """Join the default process group from torchrun's environment, once a
    process; returns whether a group exists.  device: the rank's device
    (`rank_device`), which picks the backend: NCCL for a card, gloo for the
    CPU.  A card that is asked for and missing raises."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    device = rank_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {os.environ['RANK']}: {device} requested but no CUDA device is available; "
                               "pass device='cpu' for a gloo group on the CPU")
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """The devices this process drives: one (a process a device)."""
    return 1


def host_group():
    """A gloo group over every process, for host-side integers (None
    without a process group).  Made once, on the first call, which every
    process must make at the same point (the trainers make it when built)."""
    global _host_group
    if not dist.is_initialized():
        return None
    if _host_group is None:
        _host_group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return _host_group


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier over every process (the reference's
    `accelerator.wait_for_everyone()`); `name` is JAX's label, unused."""
    if dist.is_initialized():
        dist.barrier(group=host_group())


def shutdown_distributed() -> None:
    """Leave the process group (and drop the host group made over it)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def exchange(send, to: Optional[int], recv, frm: Optional[int], group) -> list:
    """Send the tensors of `send` to global rank `to` and receive tensors
    shaped as `recv`'s (shape, dtype, device) from `frm`, every operation
    posted together (`batch_isend_irecv`), and wait; either side may be
    empty.  A bool tensor travels as bytes.  Returns the received ones."""
    recv = list(recv or ())
    got = [torch.empty(shape, dtype=torch.uint8 if dtype == torch.bool else dtype, device=device)
           for shape, dtype, device in recv]
    ops = [dist.P2POp(dist.isend, t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous(), to, group)
           for t in send or ()]
    ops += [dist.P2POp(dist.irecv, g, frm, group) for g in got]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [g.bool() if dtype == torch.bool else g for g, (_, dtype, _) in zip(got, recv)]
