"""One-call pipeline loaders.

Counterpart of `latent_diffusion_speech_tpu/infer/load.py`.

`load_reference_pipeline` rebuilds the TTS serve stack from the
*reference's* PyTorch artifacts, the migration path for its users:
  exp/diffusion/model_<step>.pt   (Unit2Mel state dict + config.yaml beside it)
  exp/lm/model_<step>.pt          (RoFormer state dict, HF parts)
  pretrain/semantic_codebook.pt   (k-means centroids, sklearn-attrs dict)
  pretrain/hifi-vaegan/{encoder,decoder}.pth
`cli/verify_import.py` checks each artifact on its own first.

`load_native_pipeline` does the same from this package's own checkpoints.
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path
from typing import Optional

__all__ = ["load_reference_pipeline", "load_native_pipeline"]


def _latest_torch_ckpt(expdir: Path) -> Optional[Path]:
    best, best_step = None, -1
    for p in expdir.glob("model_*.pt"):
        m = re.search(r"model_(\d+)\.pt$", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def load_reference_pipeline(
    diffusion_ckpt: str | Path,
    lm_ckpt: Optional[str | Path] = None,
    codebook_path: Optional[str | Path] = None,
    vocoder_path: Optional[str | Path] = None,
    dtype=None,
    device=None,
):
    """A TTSPipeline from the reference's torch checkpoints (bf16 unless
    `dtype` says otherwise; on `cuda` unless `device` says otherwise:
    without a card it raises before reading anything).

    diffusion_ckpt / lm_ckpt may be a model_<step>.pt file or an exp dir
    (latest step used).  The config.yaml beside the diffusion checkpoint
    gives the geometry, with the JAX package's rules: `out_dims` is the
    vocoder's latent width (`dimension // 2`), not the config's;
    `timesteps` / `k_step` keep `Unit2MelConfig`'s defaults; the vocoder
    comes from `vocoder_path` or `common.vocoder.ckpt`; a missing or
    unreadable codebook leaves `codebook=None`; the LM config is
    `roformer_config_from(cfg)`.  A reference key the module has no place
    for (an optional embedding the config turns off) is not loaded, as
    flax ignores it."""
    import torch

    from latent_diffusion_speech_tpu_torch.config import config_from_dict
    from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
    from latent_diffusion_speech_tpu_torch.models.diffusion.import_torch import unit2mel_state_from_torch
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel, Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.models.lm.import_hf import roformer_state_from_torch
    from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem
    from latent_diffusion_speech_tpu_torch.models.units import get_encoder_out_channels
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook

    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    diffusion_ckpt = Path(diffusion_ckpt)
    if diffusion_ckpt.is_dir():
        diffusion_ckpt = _latest_torch_ckpt(diffusion_ckpt)
    cfg_file = diffusion_ckpt.parent / "config.yaml"
    import yaml

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = config_from_dict(yaml.safe_load(cfg_file.read_text()))

    vocoder = Vocoder(cfg.common.vocoder.type, VAEGANConfig(), dtype=dtype, device=device,
                      ckpt=str(vocoder_path or cfg.common.vocoder.ckpt))

    m = cfg.diffusion.model
    model_cfg = Unit2MelConfig(
        input_channel=get_encoder_out_channels(cfg.data.encoder),
        n_spk=cfg.common.n_spk,
        use_pitch_aug=m.use_pitch_aug,
        out_dims=vocoder.dimension // 2,
        n_layers=m.n_layers,
        block_out_channels=tuple(m.block_out_channels),
        n_heads=m.n_heads,
        n_hidden=m.n_hidden,
        acoustic_scale=cfg.data.acoustic_scale,
        conv_impl=m.conv_impl,
        attn_impl=m.attn_impl,
        gelu=m.gelu,
        qkv=m.qkv,
    )
    state = torch.load(diffusion_ckpt, map_location="cpu", weights_only=False)["model"]
    state = unit2mel_state_from_torch(state, model_cfg)
    with torch.device("meta"):
        keys = Unit2Mel(model_cfg).state_dict().keys()
    diffusion = Unit2MelSystem(model_cfg, state_dict={k: v for k, v in state.items() if k in keys},
                               dtype=dtype, device=device,
                               weight_quant=getattr(cfg.common.infer, "weight_quant", "") or None)

    codebook = None
    cb_path = codebook_path or cfg.text2semantic.model.codebook_path
    try:
        codebook = load_codebook(cb_path)
    except (FileNotFoundError, ValueError):
        pass

    lm = None
    if lm_ckpt is not None:
        lm_ckpt = Path(lm_ckpt)
        if lm_ckpt.is_dir():
            lm_ckpt = _latest_torch_ckpt(lm_ckpt)
        lm_state = torch.load(lm_ckpt, map_location="cpu", weights_only=False)["model"]
        lm_cfg = roformer_config_from(cfg)
        lm = RoformerSystem(lm_cfg, state_dict=roformer_state_from_torch(lm_state, lm_cfg), dtype=dtype,
                            device=device)

    return TTSPipeline(diffusion, vocoder, lm=lm, codebook=codebook)


def load_native_pipeline(cfg, diffusion_expdir=None, lm_expdir=None, dtype=None, device=None):
    """A TTSPipeline from this package's checkpoints: the latest step of
    each experiment directory (or the given `model_<step>.ckpt`): the
    diffusion trainer's (its EMA weights when it saved them) and the LM
    trainer's (`lm_expdir`); seeded weights where none is given.  On `cuda`
    unless `device` says otherwise."""
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline

    return build_pipeline(cfg, diffusion_expdir, lm_expdir, dtype=dtype, device=device)
