"""Stage 20: diffusion training on one CUDA device.

Counterpart of `latent_diffusion_speech_tpu/cli/train_diffusion.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.train_diffusion -c configs/config.yaml [--max-steps N]

reads the config, builds the k-means unit quantizer when
`text2semantic.train.use_units_quantize` is set and the codebook file
exists, the trainer (resumed from the latest checkpoint of
`diffusion.train.expdir`), the dataset over `data.train_path` and its
loader, and trains, printing one JSON line of metrics every
`interval_log` steps.  One process, one device: no multi-process setup.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.config import Config

__all__ = ["build", "main"]


class PrintLogger:
    """Metrics as one JSON line per logged step on stdout."""

    def log(self, step: int, metrics: dict) -> None:
        print(json.dumps({"step": step, **metrics}), flush=True)


def build(cfg: Config, device=None):
    """(trainer, loader) as the entry point makes them; device None means
    `cuda`."""
    from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import DiffusionDataset
    from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
    from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    tcfg = cfg.diffusion.train
    quantizer = None
    if cfg.text2semantic.train.use_units_quantize:
        try:
            quantizer = EuclideanCodebook(load_codebook(cfg.text2semantic.model.codebook_path), device=device)
            print(f"unit quantizer: k-means codebook {tuple(quantizer.codebook.shape)}")
        except (FileNotFoundError, ValueError):
            print("unit quantizer: no codebook found, training on raw units")

    trainer = DiffusionTrainer(cfg, quantizer=quantizer, device=device)
    resumed = trainer.resume()
    print(f"{'resumed at step ' + str(trainer.step) if resumed else 'fresh start'}")

    dataset = DiffusionDataset(
        cfg.data.train_path,
        waveform_sec=cfg.data.duration,
        hop_size=cfg.data.block_size,
        sample_rate=cfg.data.sampling_rate,
        extensions=tuple(cfg.data.extensions),
        n_spk=cfg.common.n_spk,
        units_forced_mode=cfg.data.units_forced_mode,
        only_mean=cfg.common.vocoder.only_mean,
        clamp=cfg.common.vocoder.clamp,
        cache=tcfg.cache_all_data,
    )
    loader = DataLoader(dataset, tcfg.batch_size, shuffle=True, seed=tcfg.seed)
    return trainer, loader


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("train the latent diffusion model (stage 20) on one CUDA device")
    p.add_argument("--max-steps", type=int, default=None)
    args = p.parse_args(argv)
    trainer, loader = build(load(args))
    trainer.train(loader, max_steps=args.max_steps, logger=PrintLogger())


if __name__ == "__main__":
    main()
