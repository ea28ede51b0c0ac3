"""What the port's trainers check of `cfg.parallel`: that its axes fit the
world of processes.

The JAX trainers build their device mesh from `cfg.parallel` and raise when
its axes do not fit the devices (`parallel/mesh.py::_resolve_spec`).  The
port's diffusion and LM trainers run over the processes of a
`torch.distributed` group, a device each, and serve all five axes and
`dcn_data` (`parallel/`): axes that do not fit the world raise JAX's
ValueError here, before the trainer builds anything.  The codec trainer
reads no `cfg.parallel`, as the JAX one builds its mesh without the
config.
"""

from __future__ import annotations

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.parallel.dist import process_count
from latent_diffusion_speech_tpu_torch.parallel.mesh import resolve

__all__ = ["check_parallel_fits"]


def check_parallel_fits(cfg: Config) -> None:
    """Raise JAX's ValueError when the axes of `cfg.parallel` do not fit
    the world of processes (`data=-1` takes every process the other axes
    leave; `dcn_data` splits the world into slices resolved one by one)."""
    resolve(cfg.parallel, process_count())
