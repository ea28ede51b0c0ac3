"""RoFormer LM trainer on one device.

Counterpart of `latent_diffusion_speech_tpu/train/lm_trainer.py` for one
device and `type: roformer`, in f32 as the JAX entry point builds it (TF32 off
for CUDA matmuls, process-wide, as in the diffusion trainer):
* the loss is `RoformerSystem.loss` (shifted CE, -100 ignored) with dropout
  drawn from `step_generator(seed, step)`, the counterpart of
  `fold_in(PRNGKey(seed), step)`, so an interrupted and resumed run gives the
  same parameters as an uninterrupted one;
* AdamW at the `warmup_step_decay` rate, after global-norm clipping only
  when `clip_grad_norm > 0` (the LM default is -1), as optax's chain
  (`train/optim.py`);
* a NaN guard every `nan_check_interval` steps, and the `Config.debug`
  switches (`train/debug.py`);
* `evaluate` (val/loss, val/top5_acc), `validate_audio` through a frozen
  serve pipeline with the current weights, checkpoint save / resume with the
  data-stream position in the meta sidecar (`train/checkpoint.py`, which
  `cli/infer_tts.py` reads back).
The attention runs the plain path (the JAX RoFormer's `impl="xla"`): no
Pallas kernel is on the JAX LM's training path.

Raises for what is not ported (ROADMAP.md): `gradient_accumulation_steps > 1`,
`type: llama`, and any mesh axis (data, model, sequence, pipeline or expert
parallelism).  The MFU from XLA's cost analysis is left out.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem
from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.debug import check_step, install
from latent_diffusion_speech_tpu_torch.train.optim import AdamWUpdates, step_generator
from latent_diffusion_speech_tpu_torch.train.signals import GracefulShutdown

__all__ = ["LMTrainer", "top_k_accuracy", "roformer_config_from"]


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


def _check_one_device(cfg: Config) -> None:
    tcfg, par = cfg.text2semantic.train, cfg.parallel
    if tcfg.gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported yet (ROADMAP.md)")
    if cfg.text2semantic.model.type != "roformer":
        raise NotImplementedError(f"text2semantic model type {cfg.text2semantic.model.type!r}: only the RoFormer "
                                  "trains in the port (the Llama LM: ROADMAP.md Queue 1, item 8)")
    axes = {"data": par.data, "model": par.model, "seq": par.seq, "pipe": par.pipe, "expert": par.expert,
            "dcn_data": par.dcn_data}
    spread = {k: v for k, v in axes.items() if v > 1}
    if spread:
        raise NotImplementedError(f"parallel {spread}: the LM trainer runs on one device; mesh, sequence and "
                                  "pipeline parallelism are not ported (ROADMAP.md)")


class LMTrainer(AdamWUpdates):
    # the NaN guard reads the loss back every N steps (one device sync), so
    # the other steps never wait for the card; a NaN raises within N steps
    nan_check_interval: int = 50

    def __init__(self, cfg: Config, lm_cfg: Optional[RoformerConfig] = None, codebook=None, device=None):
        """device: None means `cuda` (raises without a card).  codebook: the
        k-means centroids that warm-start the semantic embeddings."""
        _check_one_device(cfg)
        self.cfg = cfg
        tcfg = cfg.text2semantic.train
        self.lm_type = cfg.text2semantic.model.type
        no_tf32()  # f32 as the JAX entry point trains
        self.lm_cfg = lm_cfg or roformer_config_from(cfg)
        self.system = RoformerSystem(self.lm_cfg, device=device, seed=tcfg.seed, codebook=codebook, training=True)
        self.device = self.system.device
        self._params = list(self.system.module.parameters())
        self._init_optimizer()
        self.step = 0
        # data-stream position for deterministic resume (the meta sidecar)
        self._epoch = 0
        self._batch_in_epoch = 0

    def _train_cfg(self):
        return self.cfg.text2semantic.train

    # -- one step --------------------------------------------------------------

    def device_put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update from one device batch, dropout drawn from
        `step_generator(seed, step)`; returns the loss and the gradients'
        global norm (before clipping) as device scalars.  A non-finite loss
        on a guarded step raises before the update."""
        generator = step_generator(self.cfg.text2semantic.train.seed, self.step, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.system.loss(batch, generator)
        with deterministic_algorithms():
            loss.backward()
        if self.step % self.nan_check_interval == 0 and not torch.isfinite(loss).item():
            raise RuntimeError(f"NaN/Inf LM loss at step {self.step}")
        gnorm = self.apply_update()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def evaluate(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Deterministic (no dropout) loss and top-5 accuracy of one batch."""
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
        version counters, which a write through `p.data` would not move."""
        pipe.lm.module.load_state_dict(self.system.module.state_dict())
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
        tcfg = self.cfg.text2semantic.train
        save_checkpoint(
            tcfg.expdir,
            self.step,
            self.system.module.state_dict(),
            self._opt_state() if tcfg.save_opt else None,
            keep=tcfg.last_save_model_num,
            meta={"epoch": self._epoch, "batch_in_epoch": self._batch_in_epoch},
        )

    def resume(self) -> bool:
        """Load the latest checkpoint of `expdir`; False when there is none."""
        tcfg = self.cfg.text2semantic.train
        step = latest_checkpoint_step(tcfg.expdir)
        if step is None:
            return False
        _, params, opt_state = load_checkpoint(tcfg.expdir, step)
        self.system.module.load_state_dict(params)
        self.step = step
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
                    metrics = self.train_step(device_batch)
                    self._batch_in_epoch += 1
                    check_step(dcfg, self.step, dict(self.system.module.named_parameters()), metrics["loss"],
                               batch=device_batch, expdir=tcfg.expdir)
                    if logger is not None and self.step % tcfg.interval_log == 0:
                        dt = time.time() - last_t
                        last_t = time.time()
                        steps_per_sec = tcfg.interval_log / max(dt, 1e-9)
                        logger.log(self.step, {
                            "train/loss": float(metrics["loss"]),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/steps_per_sec": steps_per_sec,
                            "train/samples_per_sec": steps_per_sec * int(device_batch["phone"].shape[0]),
                        })
                    if self.step % tcfg.interval_val == 0:
                        if val_loader is not None and logger is not None:
                            for vb in val_loader:
                                vb = self.device_put_batch(vb)
                                logger.log(self.step, self.evaluate(vb))
                                if tts_pipeline is not None:
                                    self.validate_audio(tts_pipeline, vb, logger)
                                break
                        self.save()
                    if max_steps and self.step >= max_steps:
                        self.save()
                        return
