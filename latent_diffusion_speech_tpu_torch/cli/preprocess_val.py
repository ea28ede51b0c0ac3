"""Stage 18: the validation set in one pass (mel + aug_mel + units + utt).

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_val.py` (the
reference's `18_preprocess_val.py:13-84`):

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_val -c configs/config.yaml \\
        [--ckpt pretrain/large-v3_encoder.pt] [--language ZH] [--device cpu]

Runs stages 11 (`process_mels`), 10 (`process_units`) and 16
(`process_tts`) over `data.valid_path`, on the card unless `--device`
says otherwise (stage 16 is host only).  The default language ZH needs the
frontend's `opencpop-strict.txt`, which the repository lacks (it raises in
both packages); EN runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.cli.preprocess_mel import process_mels
from latent_diffusion_speech_tpu_torch.cli.preprocess_tts import process_tts
from latent_diffusion_speech_tpu_torch.cli.preprocess_unit import process_units

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("val-set preprocessing (stage 18)")
    p.add_argument("--ckpt", type=str, default="pretrain/large-v3_encoder.pt")
    p.add_argument("--language", type=str, default="ZH")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32

    no_tf32()
    vocoder = Vocoder(cfg.common.vocoder.type, device=args.device, ckpt=cfg.common.vocoder.ckpt)
    encoder = UnitsEncoder(
        cfg.data.encoder, cfg.data.encoder_sample_rate, cfg.data.encoder_hop_size,
        cfg.data.units_forced_mode, ckpt_path=args.ckpt, device=args.device,
    )
    val = cfg.data.valid_path
    for name, shape in process_mels(val, vocoder, cfg.data.sampling_rate, cfg.data.extensions):
        print(f"val mel: {name} -> {shape}")
    for name, shape in process_units(
        val, encoder, cfg.data.sampling_rate, cfg.data.extensions, cfg.data.encoder_sample_rate
    ):
        print(f"val units: {name} -> {shape}")
    for name, n in process_tts(val, cfg.text2semantic.model.mode, args.language, cfg.data.extensions):
        print(f"val utt: {name} -> {n}")


if __name__ == "__main__":
    main()
