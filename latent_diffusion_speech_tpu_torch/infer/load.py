"""One-call pipeline loader over this package's own checkpoints.

Counterpart of `latent_diffusion_speech_tpu/infer/load.py::load_native_pipeline`.
`load_reference_pipeline` (the reference's torch checkpoints: the Unit2Mel,
RoFormer and HiFi-VAEGAN importers) is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

__all__ = ["load_native_pipeline"]


def load_native_pipeline(cfg, diffusion_expdir=None, lm_expdir=None, dtype=None, device=None):
    """A TTSPipeline from this package's checkpoints: the latest step of
    each experiment directory (or the given `model_<step>.ckpt`): the
    diffusion trainer's (its EMA weights when it saved them) and the LM
    trainer's (`lm_expdir`); seeded weights where none is given.  On `cuda`
    unless `device` says otherwise."""
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline

    return build_pipeline(cfg, diffusion_expdir, lm_expdir, dtype=dtype, device=device)
