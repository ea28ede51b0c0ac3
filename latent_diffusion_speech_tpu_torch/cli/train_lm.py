"""Stage 21: LM training (RoFormer or Llama), on one CUDA device or
over several (data, sequence, tensor, pipeline and expert parallelism).

Counterpart of `latent_diffusion_speech_tpu/cli/train_lm.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.train_lm -c configs/config.yaml [--max-steps N]
    torchrun --nproc_per_node=N -m latent_diffusion_speech_tpu_torch.cli.train_lm -c configs/config.yaml

reads the config, the k-means codebook when it exists (it warm-starts the
semantic embeddings), the trainer (resumed from the latest checkpoint of
`text2semantic.train.expdir`), the train and valid loaders over `utt/` +
`semantic_token/` (stages 16 and 19; `collate_text_batch` for the RoFormer,
`collate_llama_batch` for the Llama, whose dataset wraps the semantic ids
with the unshifted BOS/EOS (K, K + 1) that the collate shifts; length-sorted
batches when `length_sorted`, `loader_processes` spawn workers), a
`MetricsLogger` in the experiment directory, and the frozen serve pipeline
for validation audio (`infer/load.py::load_native_pipeline`: the diffusion
model of `diffusion.train.expdir` when it holds a checkpoint; skipped with a
message when the pipeline's files cannot be read), then trains.  Under
`torchrun` each process joins the process group first
(`parallel.initialize_distributed`: NCCL on `cuda:LOCAL_RANK`, gloo with
`--device cpu`), reads the utterances of its data coordinate (the mesh's
`index` of `size`: the ranks that differ only in `seq`, `model`, `pipe`
or `expert` read the same rows; the trainer cuts a `seq` rank's token
chunk and a `pipe` rank's microbatches from them) and trains one rank of
the mesh; the logger and the validation
pipeline live on rank 0 only (under tensor or expert parallelism its model
group evaluates with it).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.config import Config, config_to_dict

__all__ = ["build", "main"]


def build(cfg: Config, device=None):
    """(trainer, loader, val_loader, logger, pipe) as the entry point makes
    them for this process's rank; device None means `cuda`.  `logger` and
    `pipe` are None off rank 0, and `pipe` when the validation pipeline
    cannot be built."""
    from latent_diffusion_speech_tpu_torch.data.lm_dataset import (
        TextDataset,
        collate_llama_batch,
        collate_text_batch,
    )
    from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
    from latent_diffusion_speech_tpu_torch.infer.load import load_native_pipeline
    from latent_diffusion_speech_tpu_torch.parallel.dist import is_main_process
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook
    from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    tcfg = cfg.text2semantic.train
    codebook = None
    try:
        codebook = load_codebook(cfg.text2semantic.model.codebook_path)
    except (FileNotFoundError, ValueError):
        print("no semantic codebook found: seeded semantic embeddings")

    trainer = LMTrainer(cfg, codebook=codebook, device=device)
    resumed = trainer.resume()
    print(f"{'resumed at step ' + str(trainer.step) if resumed else 'fresh start'}")
    lm_cfg = trainer.lm_cfg
    if trainer.lm_type == "llama":
        sem_bos, sem_eos = lm_cfg.semantic_kmeans_num, lm_cfg.semantic_kmeans_num + 1
        collate = partial(collate_llama_batch, token_shift=lm_cfg.token_shift, phone_bos=lm_cfg.phone_bos,
                          phone_eos=lm_cfg.phone_eos, pad_id=lm_cfg.pad_token_id)
    else:
        sem_bos, sem_eos = lm_cfg.semantic_bos, lm_cfg.semantic_eos
        collate = partial(collate_text_batch, phone_pad=lm_cfg.phone_pad, semantic_pad=lm_cfg.semantic_pad)

    def make_loader(path, shuffle):
        ds = TextDataset(path, semantic_bos=sem_bos, semantic_eos=sem_eos, n_spk=cfg.common.n_spk,
                         process_index=trainer.mesh.index, process_count=trainer.mesh.size,
                         cache=tcfg.cache_all_data)
        return DataLoader(ds, tcfg.batch_size, collate=collate, shuffle=shuffle, seed=tcfg.seed,
                          num_workers=tcfg.loader_processes, length_sorted=shuffle and tcfg.length_sorted)

    loader = make_loader(cfg.data.train_path, True)
    val_loader = make_loader(cfg.data.valid_path, False)
    if not is_main_process():
        return trainer, loader, val_loader, None, None
    logger = MetricsLogger(tcfg.expdir, config_snapshot=config_to_dict(cfg))

    # the frozen diffusion stack behind validation audio
    diffusion_expdir = cfg.diffusion.train.expdir
    if latest_checkpoint_step(diffusion_expdir) is None:
        diffusion_expdir = None
    try:
        pipe = load_native_pipeline(cfg, diffusion_expdir, device=trainer.device)
    except (OSError, ValueError, NotImplementedError) as exc:
        print(f"validation audio disabled (no frozen serve pipeline: {exc})")
        pipe = None
    return trainer, loader, val_loader, logger, pipe


def main(argv: Optional[Sequence[str]] = None) -> None:
    import torch.distributed as dist

    from latent_diffusion_speech_tpu_torch.parallel.dist import (initialize_distributed, process_count, process_index,
                                                                rank_device)

    p = config_parser("train the text -> semantic LM (stage 21)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    cfg = load(args)
    device = rank_device(args.device)
    if initialize_distributed(device):
        print(f"rank {process_index()} of {process_count()}: {dist.get_backend()} process group on {device}",
              flush=True)
    trainer, loader, val_loader, logger, pipe = build(cfg, device=device)
    try:
        trainer.train(loader, val_loader=val_loader, max_steps=args.max_steps, logger=logger, tts_pipeline=pipe)
    finally:
        loader.close()
        val_loader.close()
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
