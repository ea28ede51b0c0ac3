"""One rank of the port's data-parallel CPU check (tests/test_torch_parallel.py).

Run as `python tests/_torch_mp_worker.py <out_dir>` with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK); the
test starts two.  The rank joins a gloo group and trains each case on its
rows of the global batches below, then writes `rank<r>.pt`: the losses and
parameters of every case.  The test module imports the case builders to
train the same cases in one process on the whole batches (a world of one).
Imports torch and the port only (no JAX), so the ranks start quickly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook, VectorQuantize
from latent_diffusion_speech_tpu_torch.train import diffusion_trainer
from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
from latent_diffusion_speech_tpu_torch.train.optim import step_generator

UNIT, MEL, B, STEPS = 16, 8, 4, 2  # B: the global batch, two rows a rank
UNIT2MEL = Unit2MelConfig(input_channel=UNIT, n_spk=4, out_dims=MEL, n_hidden=8, block_out_channels=(8, 8),
                          n_heads=2, timesteps=20, k_step=20)
ROFORMER = RoformerConfig(encoder=StackConfig(num_hidden_layers=1, hidden_size=32, num_attention_heads=4,
                                              intermediate_size=64),
                          decoder=StackConfig(num_hidden_layers=1, hidden_size=32, num_attention_heads=4,
                                              intermediate_size=64),
                          semantic_kmeans_num=40, n_spk=4)  # dropout 0.1: the masks are drawn by rows
# capacity factor 0.5: the global capacity drops routed choices
LLAMA_MOE = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=2, intermediate_size=48,
                 semantic_kmeans_num=32, moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
CODEC = VAEGANConfig(sampling_rate=8000, inter_channels=4, resblock_kernel_sizes=(3,),
                     resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 2), upsample_initial_channel=8,
                     upsample_kernel_sizes=(8, 4))
CODEC_BANK = dict(disc_scales=((128, 32, 128),), disc_periods=(2,))


def diffusion_config(expdir) -> Config:
    cfg = Config()
    cfg.common.n_spk = 4
    t = cfg.diffusion.train
    t.expdir, t.warm_up_steps, t.interval_log, t.interval_val, t.ema_decay = str(expdir), 2, 10_000, 10_000, 0.9
    t.save_opt = True
    return cfg


def diffusion_batches():
    """Raw (device-collated) global batches: the trainer finishes them,
    drawing the latent noise by rows."""
    g = np.random.default_rng(1)
    F, U = 16, 10
    return [{"mel_stats": g.standard_normal((B, F, 2 * MEL)).astype(np.float32) * 0.5,
             "units_raw": g.standard_normal((B, U, UNIT)).astype(np.float32),
             "unit_idx": g.integers(0, U, (B, F)).astype(np.int32),
             "spk_id": g.integers(1, 5, (B, 1)).astype(np.int32),
             "aug_shift": np.zeros((B, 1), np.float32)} for _ in range(STEPS)]


def diffusion_trainer_for(case: str, expdir) -> DiffusionTrainer:
    """`frozen`: a k-means codebook snaps the units; `vq`: the learned VQ."""
    if case == "frozen":
        codebook = np.random.default_rng(2).standard_normal((16, UNIT)).astype(np.float32)
        quantizer = EuclideanCodebook(codebook, device="cpu")
    else:
        quantizer = VectorQuantize(UNIT, 32)
    return DiffusionTrainer(diffusion_config(expdir), model_cfg=UNIT2MEL, quantizer=quantizer, device="cpu")


def lm_config(expdir, lm_type: str) -> Config:
    cfg = Config()
    cfg.common.n_spk = 4
    cfg.text2semantic.model.type = lm_type
    t = cfg.text2semantic.train
    t.expdir, t.warm_up_steps, t.weight_decay, t.interval_log, t.interval_val = str(expdir), 2, 0.01, 10_000, 10_000
    return cfg


def roformer_batches():
    """Rank 0's rows (0, 1) hold long targets, rank 1's (2, 3) short ones:
    the ranks' counts of valid targets differ (23 + 22 against 5 + 3)."""
    g = np.random.default_rng(3)
    L, S = 10, 24
    out = []
    for _ in range(STEPS):
        phone_lens, sem_lens = (10, 8, 4, 3), (24, 23, 6, 4)
        phone = np.full((B, L), ROFORMER.phone_pad, np.int32)
        tone, spk = np.zeros((B, L), np.int32), np.repeat(g.integers(1, 5, (B, 1)), L, axis=1).astype(np.int32)
        semantic = np.full((B, S), ROFORMER.semantic_pad, np.int32)
        labels = np.full((B, S), -100, np.int32)
        for i, (n, m) in enumerate(zip(phone_lens, sem_lens)):
            phone[i, :n] = g.integers(1, 60, n)
            tone[i, :n] = g.integers(0, 5, n)
            semantic[i, :m] = g.integers(0, 40, m)
            labels[i, :m] = semantic[i, :m]
        out.append({"phone": phone, "tone": tone, "semantic": semantic, "labels": labels, "spk_id": spk,
                    "encoder_attention_mask": (np.arange(L)[None] < np.array(phone_lens)[:, None]).astype(np.int32),
                    "attention_mask": (np.arange(S)[None] < np.array(sem_lens)[:, None]).astype(np.int32)})
    return out


def llama_batches():
    """Rank 0's rows draw tokens from the low quarter of the vocabulary,
    rank 1's from the high one, so the router sends the two ranks' tokens
    to different experts: a capacity counted over one rank's tokens drops
    other choices than the global one.  Padding differs by row."""
    cfg = LlamaConfig(**LLAMA_MOE)
    g = np.random.default_rng(4)
    T, V = 16, cfg.vocab_size
    out = []
    for _ in range(STEPS):
        ids = np.concatenate([g.integers(0, V // 4, (2, T)), g.integers(3 * V // 4, V, (2, T))]).astype(np.int32)
        mask = (np.arange(T)[None] < np.array([16, 12, 9, 5])[:, None]).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": mask, "labels": np.where(mask > 0, ids, -100)})
    return out


def lm_trainer_for(lm_type: str, expdir, llama_state=None) -> LMTrainer:
    if lm_type == "roformer":
        return LMTrainer(lm_config(expdir, "roformer"), lm_cfg=ROFORMER, device="cpu")
    trainer = LMTrainer(lm_config(expdir, "llama"), lm_cfg=LlamaConfig(**LLAMA_MOE), device="cpu")
    trainer.system.module.load_state_dict(llama_state)
    return trainer


def codec_audio():
    return (0.1 * np.random.default_rng(5).standard_normal((B, 1024))).astype(np.float32)


def codec_trainer_for(expdir) -> CodecTrainer:
    return CodecTrainer(CODEC, expdir=str(expdir), device="cpu", use_vq=True, vq_codebook_size=32, **CODEC_BANK)


def params(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_diffusion(trainer, batches, first_step=0):
    losses = []
    for step, b in enumerate(batches, start=first_step):
        out = trainer.train_step(trainer.device_put_batch(b), step_generator(0, step, "cpu"))
        losses.append(float(out["loss"]))
    return losses


def run_lm(trainer, batches):
    return [float(trainer.train_step(trainer.device_put_batch(b))["loss"]) for b in batches]


def main(out: Path) -> None:
    from latent_diffusion_speech_tpu_torch.parallel import initialize_distributed
    from latent_diffusion_speech_tpu_torch.parallel.mesh import shard_batch
    from latent_diffusion_speech_tpu_torch.parallel.multihost import global_shard_batch

    torch.set_num_threads(1)
    assert initialize_distributed("cpu")
    rank = torch.distributed.get_rank()
    res = {}

    def rows(batches):
        mesh = diffusion_trainer.build_mesh()
        return [shard_batch(mesh, b) for b in batches]

    for case in ("frozen", "vq"):
        t = diffusion_trainer_for(case, out / f"exp_{case}")
        res[case] = {"losses": run_diffusion(t, rows(diffusion_batches())), "params": params(t.system.module),
                     "ema": {k: v.clone() for k, v in t.ema.items()}}
        if case == "vq":
            res[case]["vq_state"] = {k: v.clone() for k, v in t.vq_state._asdict().items()}
    for lm_type in ("roformer", "llama"):
        state = torch.load(out / "llama_moe.pt") if lm_type == "llama" else None
        t = lm_trainer_for(lm_type, out / f"exp_{lm_type}", state)
        batches = rows(roformer_batches() if lm_type == "roformer" else llama_batches())
        res[lm_type] = {"losses": run_lm(t, batches), "params": params(t.system.module)}
        if lm_type == "llama":
            res[lm_type]["drop"] = [float(m.drop_fraction) for m in t.system.module.modules()
                                    if hasattr(m, "drop_fraction") and m.drop_fraction is not None]
    t = codec_trainer_for(out / "exp_codec")
    audio = rows([{"audio": codec_audio()}])[0]["audio"]
    m = t.train_step(audio, step_generator(0, 0, "cpu"))
    res["codec"] = {"losses": [m["disc/loss"], m["gen/loss"]],
                    "params": {**params(t.encoder), **params(t.generator), **{f"disc.{k}": v for k, v in
                                                                              params(t.disc).items()}},
                    "vq_state": {k: v.clone() for k, v in t.vq_state._asdict().items()}}

    # one step, a save (rank 0 writes), a resume on every rank, one more step
    writes = []
    save = diffusion_trainer.save_checkpoint
    diffusion_trainer.save_checkpoint = lambda *a, **k: (writes.append(rank), save(*a, **k))[1]
    batches = rows(diffusion_batches())
    t = diffusion_trainer_for("frozen", out / "exp_resume")
    run_diffusion(t, batches[:1])
    t.save()
    t = diffusion_trainer_for("frozen", out / "exp_resume")
    assert t.resume() and t.step == 1
    res["resume"] = {"losses": run_diffusion(t, batches[1:], first_step=1), "params": params(t.system.module),
                     "writes": writes}

    # unequal local shapes raise JAX's error on every rank
    try:
        global_shard_batch(t.mesh, {"x": np.zeros((2 + rank, 3))})
        res["unequal"] = None
    except ValueError as e:
        res["unequal"] = str(e)
    torch.save(res, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
