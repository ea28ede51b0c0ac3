"""LM trainer (RoFormer or Llama), on one device or data-parallel over
processes.

Counterpart of `latent_diffusion_speech_tpu/train/lm_trainer.py` over the
data axis of `cfg.parallel` (one device a process, `parallel/`),
`type: roformer` (encoder-decoder, `collate_text_batch` batches) or
`type: llama` (one token stream, `collate_llama_batch` batches; dense or
with the MoE feed-forward, whose auxiliary loss the Llama's `loss` adds),
in f32 as the JAX entry point builds it (TF32 off
for CUDA matmuls, process-wide, as in the diffusion trainer), or with
`dtype=torch.bfloat16` in bf16 from f32 weights (flax's `dtype`):
* the loss is the system's `loss` (shifted CE, -100 ignored) with the
  RoFormer's dropout drawn from `step_generator(seed, step)` (the Llama has
  no dropout), the counterpart of
  `fold_in(PRNGKey(seed), step)`, so an interrupted and resumed run gives the
  same parameters as an uninterrupted one;
* AdamW at the `warmup_step_decay` rate, after global-norm clipping only
  when `clip_grad_norm > 0` (the LM default is -1), as optax's chain
  (`train/optim.py`), every `gradient_accumulation_steps`-th call on the
  mean of the calls' gradients (optax.MultiSteps; the accumulator rides in
  the checkpoint's optimizer state);
* `train/mfu` beside the step rate when the card's peak is known
  (`utils/flops.py`: the products `FlopCounterMode` counts; the LMs'
  training attention is the plain path and the MoE experts are batched
  products, so it sees them all);
* a NaN guard every `nan_check_interval` steps, and the `Config.debug`
  switches (`train/debug.py`);
* `evaluate` (val/loss with the MoE auxiliary loss, val/top5_acc),
  `validate_audio` (the Llama's phone prompt recovered up to `phone_eos`)
  through a frozen
  serve pipeline with the current weights, checkpoint save / resume with the
  data-stream position in the meta sidecar (`train/checkpoint.py`, which
  `cli/infer_tts.py` reads back).
The attention runs the plain path (the JAX LMs' `impl="xla"`): no Pallas
kernel is on the JAX LMs' training path.

Data parallelism (a `parallel.mesh.Mesh` from `cfg.parallel`, or given):
each rank holds its rows of the global batch (the same padded shape on
every rank, `global_shard_batch`).  The loss is JAX's over the global batch,
sum(nll valid) / max(sum(valid), 1): the count of valid targets is summed
over the ranks, and each rank's loss is its numerator times the world over
that count, so the ranks' mean (the gradient all-reduce's average) is the
global loss and its gradient; a mean of per-rank means would weigh the
ranks' tokens unequally.  The RoFormer's dropout masks are drawn for the
global batch and each rank keeps its rows.  The MoE layers route with the
global batch's capacity and slots and take the Switch auxiliary loss's
statistics over it (`ops/moe.py`).  `evaluate` and `validate_audio` run
where they are called (the loop calls them on rank 0), with no collective;
`save` writes on rank 0, then a barrier; `train/samples_per_sec` counts the
world's rows.

Tensor and expert parallelism (`model`, `expert` above 1): the LM's
parameters are split by the JAX package's rules (`parallel/sharding.py`:
the attention's and feed-forward's products over `model`, the MoE banks
over `expert` and `model`), each rank keeping its chunks and running the
partitioned products (`parallel/tensor.py`, `ops/moe.py`); the ranks of one
model or expert group share a data coordinate, so they hold the same rows
and draw the same dropout masks.  The gradients are averaged over the data
axis only, the clipping norm is the global parameters' and AdamW acts on
the chunks; `save` writes a sharded checkpoint (`train/sharded_checkpoint.py`)
and `resume` reads either format onto this trainer's layout.  Under such a
mesh `evaluate` is a collective that every rank of the loop runs (rank 0
logs), and `validate_audio` gathers the whole weights on every rank before
rank 0 synthesizes.

Sequence parallelism (`seq` above 1, JAX's `_with_seq_parallel`): the
token dimension of every batch tensor the axis divides is cut to this
rank's chunk (JAX lays it out over `seq`), the next-token targets shifted
over the whole sequence first, so a chunk's last position scores the next
chunk's first label; the loss runs inside `ops/attention.py::
sequence_parallel` (self-attention through the ring, rotary at global
positions), the hidden dropout is drawn for the whole sequence and cut
(`RowGenerator(tokens=True)`), the MoE routes over the global token order,
and the valid-target count is summed over `data` and `seq`.  JAX's checks:
attention-probability dropout raises (the ring has none), and so does a
token length the axis does not divide.

Pipeline parallelism (`pipe` above 1): the systems' `loss_pp` with
`pipe_microbatches` microbatches; JAX reshapes the global batch into
microbatches and splits each microbatch's rows over `data`, so under
`data` too each rank gathers the data axis's rows and keeps its rows of
each microbatch (which tokens an overflowing expert drops depends on it).
The RoFormer's pipeline is deterministic: dropout raises, as in JAX.
Every rank of a pipe group holds the whole model (JAX's parameter rules
name no `pipe` axis, so checkpoints are unchanged) and backpropagates its
stage; the gradients (and the losses, each counted once) are summed over
`seq` and `pipe` and averaged over `data` (`train/optim.py`), after which
every rank takes the same update.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaSystem
from latent_diffusion_speech_tpu_torch.models.lm.registry import llama_config_from, roformer_config_from
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem
from latent_diffusion_speech_tpu_torch.ops.attention import sequence_parallel
from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, set_compute_dtype
from latent_diffusion_speech_tpu_torch.ops.moe import data_parallel
from latent_diffusion_speech_tpu_torch.parallel.dist import is_main_process, sync_global_devices
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, RowGenerator, build_mesh
from latent_diffusion_speech_tpu_torch.parallel.multihost import gather_to_host, global_shard_batch
from latent_diffusion_speech_tpu_torch.parallel.sharding import gather_full_state, local_state, shard_module, split_axes
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.debug import check_step, install
from latent_diffusion_speech_tpu_torch.train.devices import check_parallel_fits
from latent_diffusion_speech_tpu_torch.train.sharded_checkpoint import (
    load_checkpoint_sharded,
    save_checkpoint_sharded,
    sharded_checkpoint_dir,
    tree_needs_sharded_save,
)
from latent_diffusion_speech_tpu_torch.train.optim import AdamWUpdates, step_generator
from latent_diffusion_speech_tpu_torch.train.signals import GracefulShutdown
from latent_diffusion_speech_tpu_torch.utils.flops import FlopsByShape, step_mfu

__all__ = ["LMTrainer", "top_k_accuracy", "roformer_config_from", "llama_config_from"]


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Top-k accuracy over the positions whose label is not -100."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    hit = (logits.topk(k, dim=-1).indices == safe[..., None]).any(dim=-1)
    return (hit & valid).sum() / valid.sum().clamp_min(1)


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic kernels for the block (process-wide, restored
    after).  On CUDA the embedding backward of more than 3072 indices adds
    rows with atomics unless this mode is on, so repeated tokens (pads,
    frequent phones, the decoder's one token type) would make the step, and
    a resumed run, differ in the last bits.  warn_only: cuBLAS is
    deterministic on the one stream a step runs on, so its workspace notice
    is dropped."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


class LMTrainer(AdamWUpdates):
    # the NaN guard reads the loss back every N steps (one device sync), so
    # the other steps never wait for the card; a NaN raises within N steps
    nan_check_interval: int = 50

    def __init__(self, cfg: Config, lm_cfg=None, codebook=None,
                 dtype: torch.dtype = torch.float32, device=None, mesh: Optional[Mesh] = None):
        """device: None means `cuda` (raises without a card).  lm_cfg: a
        `RoformerConfig` or `LlamaConfig` (default: from `cfg`, by
        `text2semantic.model.type`).  codebook: the k-means centroids that
        warm-start the semantic embeddings.  dtype: the compute dtype (the
        weights stay f32).  mesh: the data-parallel mesh (default:
        `build_mesh(cfg.parallel)` over the process group, a world of one
        without one)."""
        if mesh is None:
            check_parallel_fits(cfg)
        self.mesh = mesh if mesh is not None else build_mesh(cfg.parallel)
        self.cfg = cfg
        tcfg = cfg.text2semantic.train
        self.lm_type = cfg.text2semantic.model.type
        if self.lm_type == "llama":
            self.lm_cfg, system = lm_cfg or llama_config_from(cfg), LlamaSystem
        elif self.lm_type == "roformer":
            self.lm_cfg, system = lm_cfg or roformer_config_from(cfg), RoformerSystem
        else:
            raise ValueError(f"unknown text2semantic model type: {self.lm_type!r}")
        self._check_parallel()
        no_tf32()  # f32 as the JAX entry point trains
        if self.lm_type == "llama":  # the Llama splits itself on the mesh, as JAX's takes it
            self.system = LlamaSystem(self.lm_cfg, device=device, seed=tcfg.seed, codebook=codebook, training=True,
                                      mesh=self.mesh)
            self.shardings = self.system.shardings
        else:
            self.system = system(self.lm_cfg, device=device, seed=tcfg.seed, codebook=codebook, training=True)
            self.shardings = shard_module(self.system.module, self.mesh)
        self.device = self.system.device
        self.dtype = dtype
        set_compute_dtype(self.system.module, None if dtype == torch.float32 else dtype)
        self._names = [n for n, _ in self.system.module.named_parameters()]
        self._params = list(self.system.module.parameters())
        self._param_axes = [split_axes(self.shardings[n]) if n in self.shardings else () for n in self._names]
        self._init_optimizer()
        self.step = 0
        # data-stream position for deterministic resume (the meta sidecar)
        self._epoch = 0
        self._batch_in_epoch = 0

    def _train_cfg(self):
        return self.cfg.text2semantic.train

    def _check_parallel(self) -> None:
        """JAX's refusals of `seq` and `pipe`, and the gradient reduction
        they need (`train/optim.py`'s `_share_axes`)."""
        spec = self.mesh.spec
        if spec.seq > 1 and self.lm_type == "roformer" and max(
                self.lm_cfg.encoder.attention_probs_dropout_prob,
                self.lm_cfg.decoder.attention_probs_dropout_prob) > 0:
            raise ValueError(
                "parallel.seq > 1 requires attention_probs_dropout_prob=0 "
                "(ring attention does not implement attention-prob "
                "dropout; hidden dropout still applies)"
            )
        if spec.pipe > 1 and self.lm_type == "roformer" and max(
                self.lm_cfg.encoder.hidden_dropout_prob, self.lm_cfg.encoder.attention_probs_dropout_prob,
                self.lm_cfg.decoder.hidden_dropout_prob, self.lm_cfg.decoder.attention_probs_dropout_prob) > 0:
            raise ValueError(
                "parallel.pipe > 1 with the roformer requires dropout off "
                "(hidden_dropout_prob=attention_probs_dropout_prob=0): "
                "the pipeline path is deterministic"
            )
        if spec.seq > 1 or spec.pipe > 1:
            self._share_axes = ("data", "seq", "pipe")

    # -- one step --------------------------------------------------------------

    def device_put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One micro-step from one device batch (an update on every
        `gradient_accumulation_steps`-th), dropout drawn from
        `step_generator(seed, step)`; returns the loss and the gradients'
        global norm (before clipping) as device scalars.  A non-finite loss
        on a guarded step raises before the update."""
        generator = step_generator(self.cfg.text2semantic.train.seed, self.step, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, generator)
        with deterministic_algorithms():
            loss.backward()
        loss = loss.detach().clone()

        def guard():
            if not torch.isfinite(loss).item():
                raise RuntimeError(f"NaN/Inf LM loss at step {self.step}")

        if self.mesh.spec.pipe > 1:
            loss /= self.mesh.spec.pipe  # every stage holds the loss: summed over `pipe`, counted once
        gnorm = self.apply_update(reduce=[loss], guard=guard if self.step % self.nan_check_interval == 0 else None)
        self.step += 1
        return {"loss": loss, "grad_norm": gnorm}

    def loss(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The training loss of one device batch (differentiable); under a
        mesh this rank's share of the global batch's loss: the ranks' mean
        is the global loss, and the mean of their gradients its gradient."""
        mesh = self.mesh
        spec = mesh.spec
        if spec.seq > 1:
            self._check_tokens(batch)
        if mesh.group is None:
            return self.system.loss(batch, generator)
        global_shard_batch(mesh, batch)
        if spec.pipe > 1 and spec.data > 1:
            batch = self._microbatch_rows(batch)
        if spec.seq > 1:
            batch = self._token_chunk(batch)
            count = (batch["targets"] != -100).sum().float()
        else:
            count = (batch["labels"][:, 1:] != -100).sum().float()
        mesh.all_reduce_sum_([count], over=("data", "seq"))
        denom = count.clamp_min(1.0) / mesh.size
        with data_parallel(self.system.module, mesh), \
                (sequence_parallel(mesh) if spec.seq > 1 else contextlib.nullcontext()):
            if spec.pipe > 1:
                return self._loss_pp(batch, denom)
            return self.system.loss(batch, RowGenerator(generator, mesh, tokens=True), denom=denom)

    def _loss_pp(self, batch: Dict[str, torch.Tensor], denom: torch.Tensor) -> torch.Tensor:
        mesh, M = self.mesh, self.cfg.parallel.pipe_microbatches
        kw = dict(microbatches=M, denom=denom, targets=batch.get("targets"))
        if self.lm_type == "llama":
            return self.system.loss_pp(batch["input_ids"], batch["labels"], mesh,
                                       attention_mask=batch.get("attention_mask"), **kw)
        return self.system.loss_pp(batch["phone"], batch["tone"], batch["semantic"], batch["labels"], mesh,
                                   spk_id=batch.get("spk_id"), encoder_attention_mask=batch.get("encoder_attention_mask"),
                                   attention_mask=batch.get("attention_mask"), **kw)

    def _check_tokens(self, batch: Dict[str, torch.Tensor]) -> None:
        """JAX's check: the token dimensions the ring splits divide by `seq`."""
        n = self.mesh.spec.seq
        for key in ("phone", "semantic", "input_ids"):
            if key in batch and batch[key].shape[1] % n != 0:
                raise ValueError(
                    f"seq-parallel: batch dim {key}={batch[key].shape[1]} "
                    f"not divisible by seq={n}; set the collate "
                    f"pad_multiple to a multiple of parallel.seq"
                )

    def _token_chunk(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's chunk of every tensor's token dimension (dimension 1,
        where the `seq` axis divides it, as JAX lays the batch out), and
        `targets`: the labels shifted over the whole sequence, then cut."""
        n, c = self.mesh.spec.seq, self.mesh.coordinate("seq")
        labels = batch["labels"]
        targets = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)], dim=1)

        def cut(x):
            if x.dim() >= 2 and x.shape[1] % n == 0:
                t = x.shape[1] // n
                return x[:, c * t:(c + 1) * t]
            return x

        out = {k: cut(v) for k, v in batch.items()}
        out["targets"] = cut(targets)
        return out

    def _microbatch_rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of each of the global batch's microbatches (JAX
        splits microbatch m, global rows [m B / M, (m + 1) B / M), over
        `data`): the data axis's rows gathered, then rows
        [m B / M + d B / (M D), ...) of each m for data coordinate d."""
        mesh, M = self.mesh, self.cfg.parallel.pipe_microbatches
        D = mesh.size
        out = {}
        for k, v in batch.items():
            if v.dim() == 0:
                out[k] = v
                continue
            whole = mesh.all_gather(v).reshape(-1, *v.shape[1:])
            B = whole.shape[0]
            if B % M != 0:
                raise ValueError(f"loss_pp: batch {B} not divisible by microbatches {M}")
            if (B // M) % D != 0:
                raise ValueError(f"loss_pp: microbatches of {B // M} rows not divisible by data={D}")
            out[k] = whole.view(M, D, B // (M * D), *v.shape[1:])[:, mesh.index].reshape(-1, *v.shape[1:])
        return out

    @torch.no_grad()
    def evaluate(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Deterministic (no dropout) loss and top-5 accuracy of one batch;
        the Llama's loss includes the MoE auxiliary loss, as JAX's."""
        if self.lm_type == "llama":
            logits, aux = self.system.module(batch["input_ids"], batch.get("attention_mask"))
            loss = self.system.loss_of(logits, aux, batch["labels"])
        else:
            logits = self.system.logits(batch)
            loss = self.system._ce(logits, batch["labels"])
        acc = top_k_accuracy(logits[:, :-1], batch["labels"][:, 1:], k=5)
        return {"val/loss": float(loss), "val/top5_acc": float(acc)}

    def validate_audio(self, pipe, batch, logger, n_items: int = 1, seed: int = 0,
                       method: str = "dpm-solver", infer_speedup: int = 50):
        """Synthesize validation audio with the CURRENT LM weights through a
        frozen pipeline (`TTSPipeline`: its diffusion model and vocoder).
        The weights are copied into `pipe.lm` with `load_state_dict` (cast to
        its dtype): K1's packed-weight cache is keyed on the parameters'
        version counters, which a write through `p.data` would not move.
        A Llama batch is one stream `[BOS, phones, EOS, semantic...]`: the
        phone prompt is recovered up to the phone EOS and served with zero
        tones and speaker 1 (the Llama conditions on neither)."""
        state = (gather_full_state(self.system.module, self.shardings, self.mesh) if self.shardings
                 else self.system.module.state_dict())
        if pipe is None:  # a rank of the model group other than the one that synthesizes
            return
        pipe.lm.module.load_state_dict(state)
        if self.lm_type == "llama":
            ids = batch["input_ids"].cpu().numpy()
            for i in range(min(n_items, ids.shape[0])):
                eos_pos = int(np.argmax(ids[i] == self.lm_cfg.phone_eos))
                if eos_pos <= 1:
                    continue
                phones = ids[i, 1:eos_pos]
                wav, sr = pipe.tts_from_phones(phones, np.zeros_like(phones), spk_id=1, seed=seed + i,
                                               method=method, infer_speedup=infer_speedup)
                if logger is not None and wav.size:
                    logger.log_audio(self.step, f"val/audio_{i}", wav, sr)
            return
        mask = batch.get("encoder_attention_mask")
        phones = batch["phone"].cpu().numpy()
        tones = batch["tone"].cpu().numpy()
        spk_ids = batch.get("spk_id")
        lengths = mask.sum(dim=-1).cpu().numpy() if mask is not None else None
        for i in range(min(n_items, phones.shape[0])):
            L = int(lengths[i]) if lengths is not None else phones.shape[1]
            spk = int(spk_ids[i].reshape(-1)[0]) if spk_ids is not None else 1
            wav, sr = pipe.tts_from_phones(phones[i, :L], tones[i, :L], spk_id=spk, seed=seed + i,
                                           method=method, infer_speedup=infer_speedup)
            if logger is not None and wav.size:
                logger.log_audio(self.step, f"val/audio_{i}", wav, sr)

    # -- checkpoints -----------------------------------------------------------

    def save(self) -> None:
        """The checkpoint, written by rank 0 (every rank holds the same
        replicated state), then a barrier over the processes; with
        parameters split across ranks, a sharded checkpoint every rank
        writes its chunks of (`train/sharded_checkpoint.py`)."""
        tcfg = self.cfg.text2semantic.train
        meta = {"epoch": self._epoch, "batch_in_epoch": self._batch_in_epoch}
        if tree_needs_sharded_save(self.shardings, self.mesh):
            save_checkpoint_sharded(
                tcfg.expdir, self.step,
                {"params": self.system.module.state_dict(),
                 "opt_state": self._opt_leaves(self._names) if tcfg.save_opt else None},
                self._tree_specs(), self.mesh, keep=tcfg.last_save_model_num, meta=meta)
        elif is_main_process():
            save_checkpoint(
                tcfg.expdir,
                self.step,
                gather_to_host(self.system.module.state_dict()),
                self._opt_state() if tcfg.save_opt else None,
                keep=tcfg.last_save_model_num,
                meta=meta,
            )
        sync_global_devices("save")

    def _tree_specs(self) -> dict:
        return {"params": self.shardings, "opt_state": self._opt_specs(self._names, self.shardings)}

    def resume(self) -> bool:
        """Load the latest checkpoint of `expdir`; False when there is none."""
        tcfg = self.cfg.text2semantic.train
        step = latest_checkpoint_step(tcfg.expdir)
        if step is None:
            return False
        self.step = step
        if sharded_checkpoint_dir(tcfg.expdir, step).exists():
            restored = load_checkpoint_sharded(
                tcfg.expdir, step,
                {"params": self.system.module.state_dict(),
                 "opt_state": self._opt_leaves(self._names) if tcfg.save_opt else None},
                self._tree_specs(), self.mesh)
            self.system.module.load_state_dict(restored["params"])
            self._reset_optimizer()
            if restored["opt_state"] is not None:
                self._load_opt_leaves(restored["opt_state"], self._names)
        else:
            _, params, opt_state = load_checkpoint(tcfg.expdir, step)
            self.system.module.load_state_dict(local_state(params, self.shardings, self.mesh))
            self._reset_optimizer()
            if tcfg.save_opt and opt_state is not None:
                self._load_opt_state(opt_state)
        meta = load_checkpoint_meta(tcfg.expdir, step)
        self._epoch = int(meta.get("epoch", 0))
        self._batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        return True

    # -- the epoch loop --------------------------------------------------------

    def train(self, loader, val_loader=None, max_steps: Optional[int] = None, logger=None,
              tts_pipeline=None, shutdown=None):
        """Epoch loop.  tts_pipeline: a frozen `TTSPipeline` that turns on
        validation audio; SIGTERM/SIGINT checkpoints once and returns
        (train/signals.py); every `interval_val` steps the first validation
        batch is evaluated (and synthesized) and a checkpoint saved."""
        tcfg = self.cfg.text2semantic.train
        dcfg = self.cfg.debug
        last_t = time.time()
        counter = FlopsByShape()
        with (shutdown or GracefulShutdown()) as stop, install(dcfg):
            start_epoch = self._epoch
            for epoch in range(start_epoch, tcfg.epochs):
                resuming_mid_epoch = epoch == start_epoch and self._batch_in_epoch > 0
                self._epoch = epoch
                if not resuming_mid_epoch:
                    self._batch_in_epoch = 0
                if hasattr(loader, "set_epoch"):
                    loader.set_epoch(epoch)
                    if resuming_mid_epoch:
                        loader.skip_batches(self._batch_in_epoch)
                for batch in loader:
                    if stop.requested:
                        self.save()
                        return
                    device_batch = self.device_put_batch(batch)
                    metrics, flops = counter.step(device_batch, lambda: self.train_step(device_batch))
                    self._batch_in_epoch += 1
                    check_step(dcfg, self.step, dict(self.system.module.named_parameters()), metrics["loss"],
                               batch=device_batch, expdir=tcfg.expdir)
                    if logger is not None and self.step % tcfg.interval_log == 0:
                        dt = time.time() - last_t
                        last_t = time.time()
                        steps_per_sec = tcfg.interval_log / max(dt, 1e-9)
                        log = {
                            "train/loss": float(metrics["loss"]),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/steps_per_sec": steps_per_sec,
                            "train/samples_per_sec": (steps_per_sec * self.mesh.size
                                                      * int(next(iter(device_batch.values())).shape[0])),
                        }
                        mfu = step_mfu(flops, steps_per_sec, self.device)
                        if mfu is not None:
                            log["train/mfu"] = mfu
                        logger.log(self.step, log)
                    if self.step % tcfg.interval_val == 0:
                        # rank 0 (the one with a logger) validates; under tensor
                        # or expert parallelism its model group runs with it
                        if val_loader is not None and (logger is not None or self.shardings):
                            for vb in val_loader:
                                vb = self.device_put_batch(vb)
                                metrics = self.evaluate(vb)
                                if logger is not None:
                                    logger.log(self.step, metrics)
                                if tts_pipeline is not None or self.shardings:
                                    self.validate_audio(tts_pipeline, vb, logger)
                                break
                        self.save()
                    if max_steps and self.step >= max_steps:
                        self.save()
                        return
