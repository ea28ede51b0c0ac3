"""Long-audio SVC inference on one CUDA device: input audio -> units ->
diffusion -> audio.

Counterpart of `latent_diffusion_speech_tpu/cli/infer_svc.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.infer_svc -c configs/config.yaml \\
        -i input.wav -o output_svc.wav [--model exp/diffusion] [--units-ckpt pretrain/large-v3_encoder.pt]

`build_pipeline` (`cli/infer_tts.py`) gets a `UnitsEncoder` for the
config's encoder; the input is RMS-sliced at silences, each voiced segment
runs units -> the config's sampler -> HiFi-VAEGAN, and the segments are
stitched with silence gaps or cross-fades (`TTSPipeline.infer_from_long_audio`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("long-audio SVC-style inference")
    p.add_argument("-i", "--input", type=str, required=True, help="input wav")
    p.add_argument("-o", "--output", type=str, default="output_svc.wav")
    p.add_argument("-s", "--spk-id", type=int, default=1)
    p.add_argument("--model", type=str, default=None, help="diffusion checkpoint path")
    p.add_argument("--units-ckpt", type=str, default="pretrain/large-v3_encoder.pt")
    p.add_argument("--speedup", type=int, default=None)
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--threshold-db", type=float, default=-40.0)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio, write_wav

    pipe = build_pipeline(cfg, args.model, None, device=args.device)
    pipe.units_encoder = UnitsEncoder(
        cfg.data.encoder, cfg.data.encoder_sample_rate, cfg.data.encoder_hop_size,
        cfg.data.units_forced_mode, ckpt_path=args.units_ckpt, device=pipe.device,
    )

    audio, sr = load_audio(args.input)
    wav, out_sr = pipe.infer_from_long_audio(
        audio, sr, spk_id=args.spk_id,
        method=args.method or cfg.common.infer.method,
        infer_speedup=args.speedup or cfg.common.infer.speedup,
        threshold_db=args.threshold_db,
    )
    write_wav(args.output, np.asarray(wav), out_sr)
    print(f"wrote {len(wav) / out_sr:.2f}s to {args.output}")


if __name__ == "__main__":
    main()
