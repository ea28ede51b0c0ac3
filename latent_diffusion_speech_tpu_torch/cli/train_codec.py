"""Codec (HiFi-VAEGAN) adversarial training on one CUDA device.

Counterpart of `latent_diffusion_speech_tpu/cli/train_codec.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.train_codec -c configs/config.yaml [--max-steps N] [--use-vq]

random crops of the audio under `<data.train_path>/audio` (the same crop
stream as the JAX CLI: `default_rng(0)`, restarted with each run), batched
into alternating D/G steps (`train/codec_trainer.py`) resumed from the
latest checkpoint of `--expdir`; metrics every `--interval-log` steps to
`<expdir>/logs/metrics.jsonl` and stdout, a checkpoint every
`--interval-save` steps and at `--max-steps`.  Step k's latent noise comes
from `step_generator(0, k)` on the CPU, where the JAX CLI splits
`PRNGKey(0)` once a step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None):
    p = config_parser("train the HiFi-VAEGAN codec on one CUDA device")
    p.add_argument("--expdir", type=str, default="exp/codec")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--crop-sec", type=float, default=0.74)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--use-vq", action="store_true")
    p.add_argument("--interval-log", type=int, default=100)
    p.add_argument("--interval-save", type=int, default=5000)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio
    from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer
    from latent_diffusion_speech_tpu_torch.train.optim import step_generator
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    vcfg = VAEGANConfig(sampling_rate=cfg.data.sampling_rate)
    trainer = CodecTrainer(vcfg, expdir=args.expdir, use_vq=args.use_vq, device=args.device)
    trainer.resume()
    logger = MetricsLogger(args.expdir)

    root = Path(cfg.data.train_path)
    files = traverse_dir(root / "audio", extensions=tuple(cfg.data.extensions))
    if not files:
        raise SystemExit(f"[x] no audio under {root / 'audio'}")

    crop = int(args.crop_sec * cfg.data.sampling_rate)
    crop -= crop % vcfg.hop_size
    rng = np.random.default_rng(0)

    cache = {}
    try:
        while True:
            batch = np.zeros((args.batch_size, crop), np.float32)
            for b in range(args.batch_size):
                name = files[int(rng.integers(len(files)))]
                if name not in cache:
                    cache[name], _ = load_audio(root / "audio" / name, target_sr=cfg.data.sampling_rate)
                audio = cache[name]
                if len(audio) <= crop:
                    batch[b, : len(audio)] = audio
                else:
                    s = int(rng.integers(0, len(audio) - crop))
                    batch[b] = audio[s: s + crop]
            metrics = trainer.train_step(batch, step_generator(0, trainer.step, "cpu"))
            if trainer.step % args.interval_log == 0:
                logger.log(trainer.step, metrics)
                print(f"step {trainer.step}: {metrics}", flush=True)
            if trainer.step % args.interval_save == 0:
                trainer.save()
            if args.max_steps and trainer.step >= args.max_steps:
                trainer.save()
                return trainer
    finally:
        logger.close()


if __name__ == "__main__":
    main()
