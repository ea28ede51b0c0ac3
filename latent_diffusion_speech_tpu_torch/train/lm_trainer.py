"""LM trainer (RoFormer or Llama) on one device.

Counterpart of `latent_diffusion_speech_tpu/train/lm_trainer.py` for one
device, `type: roformer` (encoder-decoder, `collate_text_batch` batches) or
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

Raises for what is not ported (ROADMAP.md Queue 1, item 10): any mesh axis
(data, model, sequence, pipeline or expert parallelism).
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
from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, set_compute_dtype
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.debug import check_step, install
from latent_diffusion_speech_tpu_torch.train.devices import check_one_device
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
                 dtype: torch.dtype = torch.float32, device=None):
        """device: None means `cuda` (raises without a card).  lm_cfg: a
        `RoformerConfig` or `LlamaConfig` (default: from `cfg`, by
        `text2semantic.model.type`).  codebook: the k-means centroids that
        warm-start the semantic embeddings.  dtype: the compute dtype (the
        weights stay f32)."""
        check_one_device(cfg, "LM")
        self.cfg = cfg
        tcfg = cfg.text2semantic.train
        self.lm_type = cfg.text2semantic.model.type
        if self.lm_type == "llama":
            self.lm_cfg, system = lm_cfg or llama_config_from(cfg), LlamaSystem
        elif self.lm_type == "roformer":
            self.lm_cfg, system = lm_cfg or roformer_config_from(cfg), RoformerSystem
        else:
            raise ValueError(f"unknown text2semantic model type: {self.lm_type!r}")
        no_tf32()  # f32 as the JAX entry point trains
        self.system = system(self.lm_cfg, device=device, seed=tcfg.seed, codebook=codebook, training=True)
        self.device = self.system.device
        self.dtype = dtype
        set_compute_dtype(self.system.module, None if dtype == torch.float32 else dtype)
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
        """One micro-step from one device batch (an update on every
        `gradient_accumulation_steps`-th), dropout drawn from
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
        pipe.lm.module.load_state_dict(self.system.module.state_dict())
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
                            "train/samples_per_sec": steps_per_sec * int(next(iter(device_batch.values())).shape[0]),
                        }
                        mfu = step_mfu(flops, steps_per_sec, self.device)
                        if mfu is not None:
                            log["train/mfu"] = mfu
                        logger.log(self.step, log)
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
