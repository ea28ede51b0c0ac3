"""What the port's trainers check of `cfg.parallel`: the data, model
(tensor) and expert axes are served (`parallel/`), the sequence, pipeline
and multi-slice axes are not (ROADMAP.md Queue 1, item 10).

The JAX trainers build their device mesh from `cfg.parallel` and raise when
its axes do not fit the devices (`parallel/mesh.py::_resolve_spec`).  The
port's diffusion and LM trainers run over the processes of a
`torch.distributed` group, a device each: `seq`, `pipe` and `dcn_data`
above 1 raise NotImplementedError here instead of training as if they had
not been asked for, and axes that do not fit the world raise JAX's
ValueError.  The codec trainer reads no `cfg.parallel`, as the JAX one
builds its mesh without the config.
"""

from __future__ import annotations

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.parallel.dist import process_count
from latent_diffusion_speech_tpu_torch.parallel.mesh import _resolve_spec

__all__ = ["check_one_device"]


def check_one_device(cfg: Config, trainer: str) -> None:
    """Raise NotImplementedError naming `trainer` when `seq`, `pipe` or
    `dcn_data` of `cfg.parallel` is above 1, and JAX's ValueError when the
    axes do not fit the world of processes (`data=-1` takes every process
    the other axes leave)."""
    par = cfg.parallel
    axes = {"seq": par.seq, "pipe": par.pipe, "dcn_data": par.dcn_data}
    spread = {k: v for k, v in axes.items() if v > 1}
    if spread:
        raise NotImplementedError(f"parallel {spread}: the {trainer} trainer runs data, tensor (model) and expert "
                                  "parallelism; sequence, pipeline and multi-slice parallelism are not ported "
                                  "(ROADMAP.md Queue 1, item 10)")
    _resolve_spec(par, process_count())
