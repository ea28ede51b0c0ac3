"""What the port's trainers check of `cfg.parallel`: the data axis is
served (`parallel/`), the other axes are not (ROADMAP.md Queue 1, item 10).

The JAX trainers build their device mesh from `cfg.parallel` and raise when
its axes do not fit the devices (`parallel/mesh.py::_resolve_spec`).  The
port's diffusion and LM trainers run data parallelism over the processes of
a `torch.distributed` group, a device each: tensor, sequence, pipeline,
expert and multi-slice axes above 1 raise NotImplementedError here instead
of training as if they had not been asked for, and a data axis that does not
fit the world raises JAX's ValueError.  The codec trainer reads no
`cfg.parallel`, as the JAX one builds its mesh without the config.
"""

from __future__ import annotations

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.parallel.dist import process_count
from latent_diffusion_speech_tpu_torch.parallel.mesh import _resolve_spec

__all__ = ["check_one_device"]


def check_one_device(cfg: Config, trainer: str) -> None:
    """Raise NotImplementedError naming `trainer` when an axis of
    `cfg.parallel` other than `data` (model, seq, pipe, expert, dcn_data)
    is above 1, and JAX's ValueError when the axes do not fit the world of
    processes (`data=-1` takes every process)."""
    par = cfg.parallel
    axes = {"model": par.model, "seq": par.seq, "pipe": par.pipe, "expert": par.expert, "dcn_data": par.dcn_data}
    spread = {k: v for k, v in axes.items() if v > 1}
    if spread:
        raise NotImplementedError(f"parallel {spread}: the {trainer} trainer runs data parallelism only; mesh, "
                                  "sequence, pipeline and expert parallelism are not ported (ROADMAP.md Queue 1, "
                                  "item 10)")
    _resolve_spec(par, process_count())
