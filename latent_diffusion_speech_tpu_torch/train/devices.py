"""What the port's trainers check of `cfg.parallel` (mesh parallelism is not
ported: ROADMAP.md Queue 1, item 10).

The JAX trainers build their device mesh from `cfg.parallel` and raise when
its axes do not fit the devices (`parallel/mesh.py`).  The port's diffusion
and LM trainers run on one device, so any axis above 1 raises here instead
of training on one card as if it had been asked to.  The codec trainer reads
no `cfg.parallel`, as the JAX one builds its mesh without the config.
"""

from __future__ import annotations

from latent_diffusion_speech_tpu_torch.config import Config

__all__ = ["check_one_device"]


def check_one_device(cfg: Config, trainer: str) -> None:
    """Raise NotImplementedError naming `trainer` when any axis of
    `cfg.parallel` (data, model, seq, pipe, expert, dcn_data) is above 1."""
    par = cfg.parallel
    axes = {"data": par.data, "model": par.model, "seq": par.seq, "pipe": par.pipe, "expert": par.expert,
            "dcn_data": par.dcn_data}
    spread = {k: v for k, v in axes.items() if v > 1}
    if spread:
        raise NotImplementedError(f"parallel {spread}: the {trainer} trainer runs on one device; data, mesh, "
                                  "sequence, pipeline and expert parallelism are not ported (ROADMAP.md Queue 1, "
                                  "item 10)")
