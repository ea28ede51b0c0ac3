"""A dry run over CPU processes: one step of each trainer in each layout.

The port's counterpart of `__graft_entry__.dryrun_multichip`, which runs one
real train step of the diffusion trainer and of the LM trainer in each of
its mesh layouts on virtual CPU devices.  Here `dryrun_multichip(n)` starts
n CPU processes in a gloo group (`torch.multiprocessing`, spawned) and, on
tiny shapes, runs one step in each of JAX's nine layouts that fits n ranks:
* `data-parallel`: the diffusion trainer, the RoFormer and the Llama, dense
  and with experts, each rank on its rows of one global batch;
* `dp-tp` (JAX's diffusion layout, data=n/2, model=2): the diffusion
  trainer, the RoFormer and the dense Llama with their products split;
* `seq-parallel` (data=n/2, seq=2): the RoFormer, its self-attention
  through the ring;
* `pipeline` (data=n/4, pipe=4): the Llama, four blocks over four stages;
* `roformer-pipeline` (data=n/4, pipe=4): the RoFormer's two encoder and
  two decoder layers, a slot a stage;
* `expert-parallel` (JAX's Llama layout, data=n/4, expert=4): the Llama
  with 4 experts, one a rank;
* `tp-ep` (data=n/4, model=2, expert=2): the Llama with experts, its banks
  over both axes;
* `dp-tp-pp` (data=n/4, model=2, pipe=2): the Llama, four blocks, split
  inside each stage;
* `pp-ep` (data=n/4, pipe=2, expert=2): the Llama with 2 experts inside
  the stages, the routing statistics riding the activation.
Rank 0 prints each loss, and every loss must be finite and the same on
every rank.

    python -m latent_diffusion_speech_tpu_torch.parallel.dryrun 8
"""

from __future__ import annotations

import math
import os
import socket
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

__all__ = ["dryrun_multichip", "LAYOUTS"]

# layout: (its axes but data, its cases: (name, model type, layers, experts))
_LAYOUTS = {
    "data-parallel": ({}, (("diffusion", "", 0, 0), ("roformer", "roformer", 2, 0), ("llama", "llama", 2, 0),
                           ("llama-moe", "llama", 2, 4))),
    "dp-tp": ({"model": 2}, (("diffusion", "", 0, 0), ("roformer", "roformer", 2, 0), ("llama", "llama", 2, 0))),
    "seq-parallel": ({"seq": 2}, (("roformer", "roformer", 2, 0),)),
    "pipeline": ({"pipe": 4}, (("llama", "llama", 4, 0),)),
    "roformer-pipeline": ({"pipe": 4}, (("roformer", "roformer", 2, 0),)),
    "expert-parallel": ({"expert": 4}, (("llama-moe", "llama", 2, 4),)),
    "tp-ep": ({"model": 2, "expert": 2}, (("llama-moe", "llama", 2, 4),)),
    "dp-tp-pp": ({"model": 2, "pipe": 2}, (("llama", "llama", 4, 0),)),
    "pp-ep": ({"pipe": 2, "expert": 2}, (("llama-moe", "llama", 2, 2),)),
}
LAYOUTS = tuple(_LAYOUTS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _lm_step(name, lm_type, expdir, rng, axes, layers, moe_experts=0):
    from latent_diffusion_speech_tpu_torch.config import Config
    from latent_diffusion_speech_tpu_torch.parallel.mesh import shard_batch
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    cfg = Config()
    m = cfg.text2semantic.model
    m.type, m.semantic_kmeans_num = lm_type, 16
    for stack in (m.encoder, m.decoder):
        stack.hidden_size, stack.num_attention_heads, stack.intermediate_size = 32, 2, 48
        stack.num_hidden_layers = layers
        stack.hidden_dropout_prob = stack.attention_probs_dropout_prob = 0.0
    if moe_experts:
        m.moe_experts, m.moe_capacity_factor = moe_experts, 4.0
    cfg.text2semantic.train.expdir = expdir
    for k, v in axes.items():
        setattr(cfg.parallel, k, v)
    trainer = LMTrainer(cfg, device="cpu")
    B, L = max(cfg.parallel.pipe_microbatches * trainer.mesh.size, 8), 16
    if lm_type == "llama":
        ids = rng.integers(0, trainer.lm_cfg.vocab_size, (B, L)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones_like(ids)}
    else:
        batch = {
            "phone": rng.integers(1, 40, (B, L)).astype(np.int32),
            "tone": rng.integers(0, 5, (B, L)).astype(np.int32),
            "semantic": rng.integers(0, 16, (B, L)).astype(np.int32),
            "labels": rng.integers(0, 16, (B, L)).astype(np.int32),
            "spk_id": np.ones((B, L), np.int32),
            "encoder_attention_mask": np.ones((B, L), np.int32),
            "attention_mask": np.ones((B, L), np.int32),
        }
    loss = trainer.train_step(trainer.device_put_batch(shard_batch(trainer.mesh, batch)))["loss"]
    return name, loss, dict(trainer.mesh.shape)


def _rank(index: int, n: int, port: int, expdir: str, layouts: Sequence[str]) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from latent_diffusion_speech_tpu_torch.config import Config
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
    from latent_diffusion_speech_tpu_torch.parallel.dist import initialize_distributed
    from latent_diffusion_speech_tpu_torch.parallel.mesh import shard_batch
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer
    from latent_diffusion_speech_tpu_torch.train.optim import step_generator

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    rng = np.random.default_rng(0)
    results = []
    for layout in layouts:
        axes, cases = _LAYOUTS[layout]
        label = "" if layout == "data-parallel" else f"{layout}/"
        for name, lm_type, layers, experts in cases:
            if name == "diffusion":
                cfg = Config()
                cfg.diffusion.train.expdir = f"{expdir}/{layout}/diffusion"
                for k, v in axes.items():
                    setattr(cfg.parallel, k, v)
                tiny = Unit2MelConfig(input_channel=16, n_spk=4, out_dims=8, n_hidden=16, block_out_channels=(16, 16),
                                      n_heads=2, timesteps=20, k_step=20)
                trainer = DiffusionTrainer(cfg, model_cfg=tiny, device="cpu")
                B, T = trainer.mesh.size * 2, 32
                batch = {"units": rng.standard_normal((B, T, 16)).astype(np.float32),
                         "mel": rng.standard_normal((B, T, 8)).astype(np.float32),
                         "spk_id": np.ones((B, 1), np.int32), "aug_shift": np.zeros((B, 1), np.float32)}
                loss = trainer.train_step(trainer.device_put_batch(shard_batch(trainer.mesh, batch)),
                                          step_generator(0, 0, "cpu"))["loss"]
                results.append((label + name, loss, dict(trainer.mesh.shape)))
            else:
                results.append(_lm_step(label + name, lm_type, f"{expdir}/{layout}/{name}", rng, axes, layers,
                                        experts))
    losses = torch.stack([r[1] for r in results])
    everyone = [torch.empty_like(losses) for _ in range(n)]
    torch.distributed.all_gather(everyone, losses)
    for name, loss, shape in results:
        value = float(loss)
        if not math.isfinite(value):
            raise RuntimeError(f"dryrun_multichip({n}): {name} non-finite loss {value}")
        if index == 0:
            print(f"dryrun_multichip({n}): {name} ok, loss={value:.4f}, mesh={shape}", flush=True)
    if not all(torch.equal(e, losses) for e in everyone):
        raise RuntimeError(f"dryrun_multichip({n}): the ranks' losses differ: {[e.tolist() for e in everyone]}")
    torch.distributed.destroy_process_group()


def fits(layout: str, n_devices: int) -> bool:
    """Whether `layout`'s axes divide a world of `n_devices`."""
    return n_devices % math.prod(_LAYOUTS[layout][0].values()) == 0


def dryrun_multichip(n_devices: int, layouts: Optional[Sequence[str]] = None) -> None:
    """One step of each trainer in each of `layouts` (default: every
    layout that fits `n_devices`) on `n_devices` CPU ranks over gloo;
    raises ValueError for a layout that is unknown or does not fit."""
    for layout in layouts or ():
        if layout not in LAYOUTS:
            raise ValueError(f"unknown dryrun layout {layout!r}; the layouts are {LAYOUTS}")
        if not fits(layout, n_devices):
            raise ValueError(f"dryrun layout {layout!r} does not fit {n_devices} devices")
    layouts = tuple(layouts) if layouts else tuple(lay for lay in LAYOUTS if fits(lay, n_devices))
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as expdir:
        mp.start_processes(_rank, args=(n_devices, _free_port(), expdir, layouts), nprocs=n_devices,
                           start_method="spawn")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
