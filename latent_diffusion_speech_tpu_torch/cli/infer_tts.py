"""Stage 22: end-to-end TTS on one CUDA device.

Counterpart of `latent_diffusion_speech_tpu/cli/infer_tts.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.infer_tts -c configs/config.yaml \\
        -l EN -i "Some text." -o out.wav [--long] [--model exp/diffusion/model_<step>.ckpt] \
        [--lm-model exp/lm]

text -> phones -> the LM's AR decode (`type: roformer`: K1; `type: llama`:
plain PyTorch, as in the JAX package) -> semantic tokens -> k-means
centroid units -> latent diffusion (the config's sampler) -> HiFi-VAEGAN
decode -> a 16-bit WAV file.  `--long` needs the RoFormer (it runs
`tts_batch`, which the Llama does not serve).  `build_pipeline` is the loader the HTTP
daemon (`cli/serve.py`) and `infer/load.py` share.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load

__all__ = ["build_pipeline", "main"]


def _native_state(path) -> dict:
    """The weights of a checkpoint of this package (`train/checkpoint.py`):
    `path` is an experiment directory (its latest step) or one
    `model_<step>.ckpt` file (that step).  The EMA sidecar's parameters
    replace the trained ones when the trainer saved one.  A file or
    directory in another format (the reference's `model_<step>.pt`, which
    `infer/load.py::load_reference_pipeline` reads) raises
    NotImplementedError."""
    from latent_diffusion_speech_tpu_torch.train.checkpoint import (
        _STEP_RE,
        latest_checkpoint_step,
        load_checkpoint,
        load_checkpoint_extra,
    )

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"{path}: no such checkpoint or experiment directory")
    m = None if path.is_dir() else _STEP_RE.search(path.name)
    if (m is None and not path.is_dir()) or (path.is_dir() and latest_checkpoint_step(path) is None
                                              and any(path.glob("model_*.pt"))):
        raise NotImplementedError(
            f"{path}: not a checkpoint of this package (model_<step>.ckpt); a reference model_<step>.pt loads "
            "through infer/load.py::load_reference_pipeline (check it first with cli/verify_import.py)"
        )
    expdir, step = (path, None) if m is None else (path.parent, int(m.group(1)))
    step, params, _ = load_checkpoint(expdir, step)
    averaged = load_checkpoint_extra(expdir, "ema", step)
    return {**params, **averaged} if averaged is not None else params


def build_pipeline(cfg, diffusion_ckpt=None, lm_ckpt=None, dtype=None, device=None):
    """The serve pipeline of `cfg` (bf16 unless `dtype` says otherwise; on
    `cuda` unless `device` says otherwise: without a card it raises).

    Weights: the diffusion model from `diffusion_ckpt` (an experiment
    directory or a `model_<step>.ckpt`, the EMA weights when saved), else
    seeded ones; the LM likewise from `lm_ckpt` (the LM trainer's
    checkpoints, `cli/train_lm.py`), else seeded; the k-means centroids from
    `text2semantic.model.codebook_path`, else `default_rng(0)` centroids;
    the vocoder from the reference's `encoder.pth` / `decoder.pth` in the
    `common.vocoder.ckpt` directory, else seeded (with a notice)."""
    import torch

    from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.models.lm.registry import get_language_model
    from latent_diffusion_speech_tpu_torch.models.units import get_encoder_out_channels
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook

    device = resolve_device(device)
    dtype = dtype or torch.bfloat16

    mcfg = cfg.text2semantic.model
    try:
        codebook = load_codebook(mcfg.codebook_path)
    except FileNotFoundError:
        print(f"[!] no semantic codebook at {mcfg.codebook_path}; using random centroids")
        codebook = np.random.default_rng(0).standard_normal(
            (mcfg.semantic_kmeans_num, get_encoder_out_channels(cfg.data.encoder))
        ).astype(np.float32)

    m = cfg.diffusion.model
    model_cfg = Unit2MelConfig(
        input_channel=codebook.shape[1],
        n_spk=cfg.common.n_spk,
        use_pitch_aug=m.use_pitch_aug,
        out_dims=m.out_dims,
        n_layers=m.n_layers,
        block_out_channels=tuple(m.block_out_channels),
        n_heads=m.n_heads,
        n_hidden=m.n_hidden,
        acoustic_scale=cfg.data.acoustic_scale,
        timesteps=m.timesteps,
        k_step=m.k_step_max,
        conv_impl=m.conv_impl,
        attn_impl=m.attn_impl,
        gelu=m.gelu,
        qkv=m.qkv,
    )
    if not diffusion_ckpt:
        print("[!] no diffusion checkpoint given; seeded random weights")
    state = _native_state(diffusion_ckpt) if diffusion_ckpt else None
    diffusion = Unit2MelSystem(model_cfg, state_dict=state, dtype=dtype, device=device,
                               weight_quant=getattr(cfg.common.infer, "weight_quant", "") or None)

    if not lm_ckpt:
        print("[!] no LM checkpoint given; seeded random weights")
    lm = get_language_model(cfg, dtype=dtype, device=device, state_dict=_native_state(lm_ckpt) if lm_ckpt else None)

    vocoder_ckpt = cfg.common.vocoder.ckpt
    if not (vocoder_ckpt and Path(vocoder_ckpt).is_dir()):
        print(f"[!] no vocoder checkpoint at {vocoder_ckpt}; seeded random weights")
    vocoder = Vocoder(cfg.common.vocoder.type, VAEGANConfig(), dtype=dtype, device=device, ckpt=vocoder_ckpt)
    return TTSPipeline(diffusion, vocoder, lm=lm, codebook=codebook)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("end-to-end TTS inference (stage 22)")
    p.add_argument("-i", "--text", type=str, required=True)
    p.add_argument("-o", "--output", type=str, default="output.wav")
    p.add_argument("-l", "--language", type=str, default="ZH")
    p.add_argument("-s", "--spk-id", type=int, default=1)
    p.add_argument("--model", type=str, default=None, help="diffusion checkpoint path")
    p.add_argument("--lm-model", type=str, default=None,
                   help="LM checkpoint path (an experiment dir or a model_<step>.ckpt)")
    p.add_argument("--speedup", type=int, default=None)
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--weight-quant", type=str, default=None, choices=["int8"],
                   help="serve-only int8 UNet weights (ops/weight_quant.py)")
    p.add_argument("--long", action="store_true",
                   help="segment long text into sentence-sized pieces and "
                        "synthesize them as one batched call (tts_long_text)")
    p.add_argument("--pause-ms", type=float, default=180.0,
                   help="silence between pieces in --long mode")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav

    if args.weight_quant:
        cfg.common.infer.weight_quant = args.weight_quant
    pipe = build_pipeline(cfg, args.model, args.lm_model, device=args.device)
    kw = dict(
        language=args.language,
        spk_id=args.spk_id,
        method=args.method or cfg.common.infer.method,
        infer_speedup=args.speedup or cfg.common.infer.speedup,
    )
    if args.long:
        wav, sr = pipe.tts_long_text(args.text, pause_ms=args.pause_ms, **kw)
    else:
        wav, sr = pipe.tts(args.text, **kw)
    write_wav(args.output, np.asarray(wav), sr)
    print(f"wrote {len(wav) / sr:.2f}s to {args.output}")


if __name__ == "__main__":
    main()
