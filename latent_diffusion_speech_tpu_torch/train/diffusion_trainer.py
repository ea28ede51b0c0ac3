"""Diffusion trainer on one device.

Counterpart of `latent_diffusion_speech_tpu/train/diffusion_trainer.py`
for one device (no mesh, no sharding), in f32 as the JAX training entry
point runs it (TF32 off for CUDA matmuls and convolutions):
* the loss is `Unit2MelSystem.loss` on units snapped to a frozen k-means
  codebook (`EuclideanCodebook`, the K6 kernel on the card) when one is
  given; the UNet's self-attention runs K4 forward and backward;
* AdamW (the config's lr and weight_decay, betas (0.9, 0.999), eps 1e-8)
  after global-norm clipping, g * min(1, max / |g|) (optax's
  clip_by_global_norm), at the `warmup_step_decay` rate of the optimizer's
  update count (0 for the first update, as optax counts);
* an optional EMA of the parameters (`ema_decay > 0`) for evaluation;
* checkpoint save / scan-resume with retention, and the data-stream
  position in the meta sidecar;
* the `Config.debug` switches (`train/debug.py`): anomaly detection and the
  periodic finiteness check with its batch dump.
The per-step generator is a pure function of (seed, step), the counterpart
of `fold_in(PRNGKey(seed), step)`, so an interrupted and resumed run gives
the same parameters as an uninterrupted one.

Not ported yet (ROADMAP.md): the learned `VectorQuantize`,
`gradient_accumulation_steps > 1`, the sharded checkpoint,
mixed-precision training, and `validate_full`'s spectrogram / vocoder
logging and cost-analysis MFU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.units import get_encoder_out_channels
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_extra,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.debug import check_step, install
from latent_diffusion_speech_tpu_torch.train.optim import AdamWUpdates, global_norm, step_generator
from latent_diffusion_speech_tpu_torch.train.signals import GracefulShutdown

__all__ = ["DiffusionTrainer", "step_generator", "global_norm"]


class DiffusionTrainer(AdamWUpdates):
    def __init__(
        self,
        cfg: Config,
        model_cfg: Optional[Unit2MelConfig] = None,
        quantizer: Optional[EuclideanCodebook] = None,
        device=None,
    ):
        """device: None means `cuda` (raises without a card).  quantizer: a
        frozen k-means `EuclideanCodebook` (on the same device) or None."""
        self.cfg = cfg
        tcfg = cfg.diffusion.train
        if tcfg.gradient_accumulation_steps > 1:
            raise NotImplementedError("gradient_accumulation_steps > 1 is not ported yet (ROADMAP.md)")
        if quantizer is not None and not isinstance(quantizer, EuclideanCodebook):
            raise NotImplementedError("only the k-means EuclideanCodebook snap is ported; "
                                      "the learned VectorQuantize is not (ROADMAP.md)")
        units_width = get_encoder_out_channels(cfg.data.encoder)
        # f32 as the JAX entry point trains: CUDA matmuls and convolutions in
        # full f32, not TF32 (process-wide switches, off for the whole run)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = cfg.diffusion.model
        self.model_cfg = model_cfg or Unit2MelConfig(
            input_channel=units_width,
            n_spk=cfg.common.n_spk,
            use_pitch_aug=m.use_pitch_aug,
            out_dims=m.out_dims,
            n_layers=m.n_layers,
            block_out_channels=tuple(m.block_out_channels),
            n_heads=m.n_heads,
            n_hidden=m.n_hidden,
            acoustic_scale=cfg.data.acoustic_scale,
            timesteps=m.timesteps,
            k_step=m.k_step_max,
            conv_impl=m.conv_impl,
            attn_impl=m.attn_impl,
            gelu=m.gelu,
            qkv=m.qkv,
        )
        self.system = Unit2MelSystem(self.model_cfg, device=device, seed=tcfg.seed)
        self.system.module.train()
        self.device = self.system.device
        self.quantizer = quantizer
        self._params = list(self.system.module.parameters())
        self._init_optimizer()
        self.step = 0
        # data-stream position for deterministic resume (the meta sidecar)
        self._epoch = 0
        self._batch_in_epoch = 0
        self.ema_decay = tcfg.ema_decay or 0.0
        self.ema = self._param_copy() if self.ema_decay > 0 else None

    def _train_cfg(self):
        return self.cfg.diffusion.train

    def _param_copy(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.system.module.named_parameters()}

    # -- one step --------------------------------------------------------------

    def device_put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}
        if "spk_id" in out:
            out["spk_id"] = out["spk_id"].long()
        return out

    def _quantized(self, units: torch.Tensor) -> torch.Tensor:
        return self.quantizer(units) if self.quantizer is not None else units

    def loss(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The training loss of one device batch (differentiable)."""
        return self.system.loss(self._quantized(batch["units"]), batch["mel"], generator,
                                spk_id=batch.get("spk_id"), aug_shift=batch.get("aug_shift"))

    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One update from one device batch; returns the loss and the
        gradients' global norm (before clipping) as device scalars."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, generator)
        loss.backward()
        gnorm = self.apply_update()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm}

    def apply_update(self) -> torch.Tensor:
        """Clip, take one AdamW step (`AdamWUpdates.apply_update`) and
        update the EMA; returns the global norm before clipping."""
        gnorm = super().apply_update()
        if self.ema is not None:
            with torch.no_grad():
                for n, p in self.system.module.named_parameters():
                    self.ema[n].mul_(self.ema_decay).add_(p, alpha=1 - self.ema_decay)
        return gnorm

    # -- evaluation ------------------------------------------------------------

    @contextlib.contextmanager
    def eval_weights(self):
        """The module with the EMA weights loaded (when ema_decay > 0) for
        the duration of the block; the live weights are restored after."""
        if self.ema is None:
            yield self.system
            return
        live = self._param_copy()
        module = self.system.module
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(self.ema[n])
        try:
            yield self.system
        finally:
            with torch.no_grad():
                for n, p in module.named_parameters():
                    p.copy_(live[n])

    def validate(self, batch, generator, method: Optional[str] = None, speedup: Optional[int] = None):
        """Run the sampler on a device batch with the evaluation weights;
        returns the generated mel (B, T, M)."""
        method = method or self.cfg.common.infer.method
        speedup = speedup or self.cfg.common.infer.speedup
        units = self._quantized(batch["units"])
        with self.eval_weights() as system:
            return system.infer(units, generator, spk_id=batch.get("spk_id"), method=method,
                                infer_speedup=speedup)

    def validate_full(self, val_loader, generator, logger=None, max_batches: int = 2) -> Dict[str, float]:
        """Validation loss on the live weights over `max_batches` batches,
        and the sampler's mean |mel - gt| on the first (the config's
        `common.infer.method`; the port's sampler raises for one it has not
        ported)."""
        losses, metrics = [], {}
        for bi, batch in enumerate(val_loader):
            if bi >= max_batches:
                break
            batch = self.device_put_batch(batch)
            with torch.no_grad():
                losses.append(float(self.loss(batch, generator)))
            if bi == 0:
                mel = self.validate(batch, generator)
                metrics["val/mel_abs_err"] = float((mel - batch["mel"]).abs().mean())
        if losses:
            metrics["val/loss"] = float(np.mean(losses))
        if logger is not None and metrics:
            logger.log(self.step, metrics)
        return metrics

    # -- checkpoints -----------------------------------------------------------

    def save(self) -> None:
        tcfg = self.cfg.diffusion.train
        opt_state = self._opt_state() if tcfg.save_opt else None
        save_checkpoint(
            tcfg.expdir,
            self.step,
            self.system.module.state_dict(),
            opt_state,
            keep=tcfg.last_save_model_num,
            meta={"epoch": self._epoch, "batch_in_epoch": self._batch_in_epoch},
            extra={"ema": self.ema} if self.ema is not None else None,
        )

    def resume(self) -> bool:
        """Load the latest checkpoint of `expdir`; False when there is none."""
        tcfg = self.cfg.diffusion.train
        step = latest_checkpoint_step(tcfg.expdir)
        if step is None:
            return False
        _, params, opt_state = load_checkpoint(tcfg.expdir, step)
        self.system.module.load_state_dict(params)
        self.step = step
        self._reset_optimizer()
        if tcfg.save_opt and opt_state is not None:
            self._load_opt_state(opt_state)
        if self.ema_decay > 0:
            # a checkpoint without the EMA sidecar restarts it from the weights
            ema = load_checkpoint_extra(tcfg.expdir, "ema", step)
            self.ema = ({n: t.to(self.device) for n, t in ema.items()} if ema is not None
                        else self._param_copy())
        meta = load_checkpoint_meta(tcfg.expdir, step)
        self._epoch = int(meta.get("epoch", 0))
        self._batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        return True

    # -- the epoch loop --------------------------------------------------------

    def train(self, loader, val_loader=None, max_steps: Optional[int] = None, logger=None, shutdown=None):
        """Epoch loop: SIGTERM/SIGINT checkpoints once and returns
        (train/signals.py); a save every `interval_val` steps and at
        `max_steps`; the `Config.debug` checks after each step."""
        tcfg = self.cfg.diffusion.train
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
                    batch_size = int(next(iter(device_batch.values())).shape[0])
                    metrics = self.train_step(device_batch, step_generator(tcfg.seed, self.step, self.device))
                    self._batch_in_epoch += 1
                    check_step(dcfg, self.step, dict(self.system.module.named_parameters()), metrics["loss"],
                               batch=device_batch, expdir=tcfg.expdir)
                    if self.step % tcfg.interval_log == 0 and logger is not None:
                        dt = time.time() - last_t
                        last_t = time.time()
                        steps_per_sec = tcfg.interval_log / max(dt, 1e-9)
                        logger.log(self.step, {
                            "train/loss": float(metrics["loss"]),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/steps_per_sec": steps_per_sec,
                            "train/samples_per_sec": steps_per_sec * batch_size,
                        })
                    if self.step % tcfg.interval_val == 0:
                        self.save()
                        if val_loader is not None:
                            self.validate_full(val_loader, step_generator(tcfg.seed, self.step, self.device, 1),
                                               logger=logger)
                    if max_steps and self.step >= max_steps:
                        self.save()
                        return
