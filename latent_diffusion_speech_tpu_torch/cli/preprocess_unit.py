"""Stage 10: audio -> semantic units (`units/*.npy`) on one CUDA device.

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_unit.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_unit -c configs/config.yaml \\
        [--ckpt pretrain/large-v3_encoder.pt]

Each file of `<data.train_path>/audio` is read at the encoder rate, padded
with zeros to a half-second bucket, encoded (Whisper-large-v3 by default),
cropped to its true frame count and saved as f32 `(T // hop, C)`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio

__all__ = ["process_units", "main"]


def _bucket_len(n: int, sr: int) -> int:
    """Round up to the next half-second (the bucket `UnitsEncoder.encode` pads to)."""
    step = sr // 2
    return max(step, ((n + step - 1) // step) * step)


def process_units(path_root: str | Path, encoder, sample_rate: int, extensions=("wav",), device_sr: int = 16000):
    """Yields (file name, units shape) as each file's units are saved.
    `sample_rate` is the corpus rate (unused: files are read at `device_sr`)."""
    root = Path(path_root)
    out_root = root / "units"
    for name_ext in traverse_dir(root / "audio", extensions=extensions):
        audio, _ = load_audio(root / "audio" / name_ext, target_sr=device_sr)
        true_units_len = len(audio) // encoder.encoder_hop_size
        padded = np.zeros(_bucket_len(len(audio), device_sr), np.float32)
        padded[: len(audio)] = audio
        units = encoder.encode(padded, device_sr)
        units = units[0, :true_units_len].float().cpu().numpy()
        out = out_root / (name_ext + ".npy")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, units)
        yield name_ext, units.shape


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("audio -> semantic units (stage 10)")
    p.add_argument("--ckpt", type=str, default="pretrain/large-v3_encoder.pt")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder

    encoder = UnitsEncoder(
        cfg.data.encoder,
        cfg.data.encoder_sample_rate,
        cfg.data.encoder_hop_size,
        cfg.data.units_forced_mode,
        ckpt_path=args.ckpt,
        device=args.device,
    )
    for name, shape in process_units(
        cfg.data.train_path, encoder, cfg.data.sampling_rate, cfg.data.extensions,
        device_sr=cfg.data.encoder_sample_rate,
    ):
        print(f"units: {name} -> {shape}")


if __name__ == "__main__":
    main()
