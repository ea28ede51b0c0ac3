"""Stage 20: diffusion training, on one CUDA device or data-parallel over
several.

Counterpart of `latent_diffusion_speech_tpu/cli/train_diffusion.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.train_diffusion -c configs/config.yaml [--max-steps N]
    torchrun --nproc_per_node=N -m latent_diffusion_speech_tpu_torch.cli.train_diffusion -c configs/config.yaml

reads the config, builds the k-means unit quantizer when
`text2semantic.train.use_units_quantize` is set and the codebook file
exists, the trainer (resumed from the latest checkpoint of
`diffusion.train.expdir`), the dataset over `data.train_path` and its
loader (`loader_processes` spawn workers; batches through the native
reader, raw and finished on the card with `device_collate`, units shipped
in `transfer_dtype`; pinned in the loader's thread), and trains, printing one JSON
line of metrics every `interval_log` steps.  Under `torchrun` each process
joins the process group first (`parallel.initialize_distributed`: NCCL on
its card `cuda:LOCAL_RANK`, gloo with `--device cpu`), reads its share of
the files of its data coordinate (the mesh's `index` of `size`: the ranks
that differ only in `seq`, `model`, `pipe` or `expert` read the same rows)
and trains one rank of the mesh (`cfg.parallel.data`, -1 for every process
the other axes leave; `cfg.parallel.model` splits the UNet over ranks,
`seq` and `pipe` replicate it as JAX's trainer does); rank 0 prints the
metrics.
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
    """(trainer, loader) as the entry point makes them, for this process's
    rank when a process group exists; device None means `cuda`."""
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
        device_collate=tcfg.device_collate,
        transfer_dtype=tcfg.transfer_dtype,
        process_index=trainer.mesh.index,  # the data coordinate: a model group reads one share
        process_count=trainer.mesh.size,
    )
    loader = DataLoader(dataset, tcfg.batch_size, shuffle=True, seed=tcfg.seed, num_workers=tcfg.loader_processes,
                        device_put=trainer.pin_batch)
    return trainer, loader


def main(argv: Optional[Sequence[str]] = None) -> None:
    import torch.distributed as dist

    from latent_diffusion_speech_tpu_torch.parallel.dist import (initialize_distributed, is_main_process, process_count,
                                                                process_index, rank_device)

    p = config_parser("train the latent diffusion model (stage 20)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    cfg = load(args)
    device = rank_device(args.device)
    if initialize_distributed(device):
        print(f"rank {process_index()} of {process_count()}: {dist.get_backend()} process group on {device}",
              flush=True)
    trainer, loader = build(cfg, device=device)
    trainer.train(loader, max_steps=args.max_steps, logger=PrintLogger() if is_main_process() else None)


if __name__ == "__main__":
    main()
