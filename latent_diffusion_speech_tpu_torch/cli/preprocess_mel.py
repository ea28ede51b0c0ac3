"""Stage 11: audio -> VAE latent stats (`mel/*.npy` + volume-augmented `aug_mel/`).

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_mel.py` (the
reference's `11_preprocess_train_mel.py:20-41`):

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_mel -c configs/config.yaml [--device cpu]

Each file of `<data.train_path>/audio` is read at the corpus rate and
encoded by the HiFi-VAEGAN encoder of `common.vocoder.ckpt` (seeded weights
when that directory does not exist) into concat([m, logs]) latents,
(T // 512, 256) f32, saved as `mel/<name>.npy`; a copy with a random gain
10**u, u ~ U(-1, min(1, log10(1 / peak))), drawn from
`np.random.default_rng(seed)` in file order as in JAX, is saved as
`aug_mel/<name>.npy`.  The codec runs in f32 with TF32 off, on the card
unless `--device` says otherwise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio

__all__ = ["process_mels", "main"]


def process_mels(path_root, vocoder, sample_rate, extensions=("wav",), use_aug=True, seed=0):
    """Yields (file name, latents shape) as each file's latents are saved."""
    root = Path(path_root)
    rng = np.random.default_rng(seed)
    for name_ext in traverse_dir(root / "audio", extensions=extensions):
        audio, _ = load_audio(root / "audio" / name_ext, target_sr=sample_rate)
        mel = vocoder.extract(audio[None], sample_rate)[0].float().cpu().numpy()
        out = root / "mel" / (name_ext + ".npy")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, mel)

        if use_aug:
            # random gain in log10 space (ref 11_:31-36)
            max_amp = float(np.max(np.abs(audio))) + 1e-5
            max_shift = min(1.0, np.log10(1.0 / max_amp))
            log10_vol_shift = rng.uniform(-1.0, max_shift)
            aug_audio = audio * (10.0 ** log10_vol_shift)
            aug = vocoder.extract(aug_audio[None], sample_rate)[0].float().cpu().numpy()
            out = root / "aug_mel" / (name_ext + ".npy")
            out.parent.mkdir(parents=True, exist_ok=True)
            np.save(out, aug)
        yield name_ext, mel.shape


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("audio -> VAE latents (stage 11)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32

    no_tf32()
    vocoder = Vocoder(cfg.common.vocoder.type, device=args.device, ckpt=cfg.common.vocoder.ckpt)
    for name, shape in process_mels(cfg.data.train_path, vocoder, cfg.data.sampling_rate, cfg.data.extensions):
        print(f"mel: {name} -> {shape}")


if __name__ == "__main__":
    main()
