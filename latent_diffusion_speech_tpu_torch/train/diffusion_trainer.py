"""Diffusion trainer on one device.

Counterpart of `latent_diffusion_speech_tpu/train/diffusion_trainer.py`
for one device (no mesh, no sharding), in f32 as the JAX training entry
point runs it (TF32 off for CUDA matmuls and convolutions), or with
`dtype=torch.bfloat16` in bf16 from f32 weights (flax's `dtype`: the
products run in bf16, the norms' statistics and the loss in f32; K4 takes
its bf16 entries on the card):
* the loss is `Unit2MelSystem.loss` on units snapped to a frozen k-means
  codebook (`EuclideanCodebook`, the K6 kernel on the card), or quantized
  by the learned `VectorQuantize`, trained jointly: its commitment loss is
  added and its EMA codebook steps with every call; the UNet's
  self-attention runs K4 forward and backward;
* AdamW (the config's lr and weight_decay, betas (0.9, 0.999), eps 1e-8)
  after global-norm clipping, g * min(1, max / |g|) (optax's
  clip_by_global_norm), at the `warmup_step_decay` rate of the optimizer's
  update count (0 for the first update, as optax counts), every
  `gradient_accumulation_steps`-th call on the mean of the calls' gradients
  (`train/optim.py`, optax.MultiSteps);
* `remat=True` recomputes the UNet's blocks in the backward;
* an optional EMA of the parameters (`ema_decay > 0`) for evaluation,
  updated on every call, as in the JAX trainer;
* checkpoint save / scan-resume with retention, and the data-stream
  position in the meta sidecar; the VQ state as the
  `model_<step>_semantic_codebook.ckpt` sidecar, which resume does not
  read, as the JAX trainer does not (ROADMAP.md R9);
* `train/mfu` beside the step rate when the card's peak is known
  (`utils/flops.py`);
* `validate_full`: the validation loss, the sampler's mel error, the
  spectrogram triptych and, given a vocoder, the audio of the first item;
* the `Config.debug` switches (`train/debug.py`): anomaly detection and the
  periodic finiteness check with its batch dump;
* device-side collation: a raw batch (`DiffusionDataset(device_collate=True)`:
  `mel_stats`, `units_raw`, `unit_idx`) is finished inside the step, on the
  card (`finalize`: the units gathered by `unit_idx` and cast to f32, the
  latent z = m + eps * exp(logs) with eps from the step's generator, the
  clamp); a host-collated batch passes through unchanged.  `pin_batch`, the
  loader's `device_put`, makes the batch pinned host tensors in the
  loader's thread, so `device_put_batch`'s copy to the card is asynchronous.
The per-step generator is a pure function of (seed, step), the counterpart
of `fold_in(PRNGKey(seed), step)`, so an interrupted and resumed run gives
the same parameters as an uninterrupted one.

Not ported (ROADMAP.md Queue 1, item 10): the sharded checkpoint, and any
mesh axis of `cfg.parallel` above 1, which raises when the trainer is built
(`train/devices.py`), where the JAX trainer builds its mesh from it.
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
from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, set_compute_dtype
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook, VectorQuantize
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_extra,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.debug import check_step, install
from latent_diffusion_speech_tpu_torch.train.devices import check_one_device
from latent_diffusion_speech_tpu_torch.train.optim import AdamWUpdates, global_norm, step_generator
from latent_diffusion_speech_tpu_torch.train.signals import GracefulShutdown
from latent_diffusion_speech_tpu_torch.utils.flops import FlopsByShape, step_mfu

__all__ = ["DiffusionTrainer", "step_generator", "global_norm"]


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    if v.dtype == np.uint16:  # bf16 bits
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(v))


class DiffusionTrainer(AdamWUpdates):
    def __init__(
        self,
        cfg: Config,
        model_cfg: Optional[Unit2MelConfig] = None,
        quantizer=None,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        device=None,
    ):
        """device: None means `cuda` (raises without a card).  quantizer: a
        frozen k-means `EuclideanCodebook` (on the same device), a learned
        `VectorQuantize` (its state is made here from seed + 1), or None.
        dtype: the compute dtype (the weights stay f32).  remat: recompute
        the UNet's blocks in the backward."""
        check_one_device(cfg, "diffusion")
        self.cfg = cfg
        tcfg = cfg.diffusion.train
        if quantizer is not None and not isinstance(quantizer, (EuclideanCodebook, VectorQuantize)):
            raise TypeError(f"quantizer must be an EuclideanCodebook or a VectorQuantize, got {type(quantizer)}")
        units_width = get_encoder_out_channels(cfg.data.encoder)
        no_tf32()  # f32 as the JAX entry point trains
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
        self.system = Unit2MelSystem(self.model_cfg, device=device, seed=tcfg.seed, remat=remat)
        self.system.module.train()
        self.device = self.system.device
        self.dtype = dtype
        set_compute_dtype(self.system.module, None if dtype == torch.float32 else dtype)
        self.quantizer = quantizer
        self._vq = quantizer if isinstance(quantizer, VectorQuantize) else None
        self.vq_state = (self._vq.init(torch.Generator().manual_seed(tcfg.seed + 1), self.device)
                         if self._vq is not None else None)
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

    def pin_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch as host tensors, pinned when the trainer runs on a
        card (the loader's `device_put`, run in its producer thread)."""
        out = {k: _host_tensor(v) for k, v in batch.items()}
        return {k: v.pin_memory() for k, v in out.items()} if self.device.type == "cuda" else out

    def device_put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A numpy or host-tensor batch on the trainer's device; uint16
        arrays are bf16 bits (`transfer_dtype="bfloat16"`)."""
        out = {k: _host_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}
        for k in ("spk_id", "unit_idx"):
            if k in out:
                out[k] = out[k].long()
        return out

    def finalize(self, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        """(units, mel) of a device batch: a raw batch finished on its device
        (JAX `finalize`), a host-collated one as it is."""
        if "units_raw" not in batch:
            return batch["units"], batch["mel"]
        raw, idx = batch["units_raw"], batch["unit_idx"]
        units = torch.gather(raw.float(), 1, idx[..., None].expand(-1, -1, raw.shape[-1]))
        m, logs = batch["mel_stats"].chunk(2, dim=-1)
        vcfg = self.cfg.common.vocoder
        if vcfg.only_mean:
            mel = m
        else:
            mel = m + torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype) * torch.exp(logs)
        if vcfg.clamp and vcfg.clamp > 0:
            mel = mel.clamp(-vcfg.clamp, vcfg.clamp)
        return units, mel

    def _quantized(self, units: torch.Tensor) -> torch.Tensor:
        """Units as evaluation sees them: snapped, or through the VQ
        without its EMA step."""
        if self._vq is not None:
            return self._vq(self.vq_state, units, train=False)[0]
        return self.quantizer(units) if self.quantizer is not None else units

    def loss_and_vq_state(self, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        """(training loss of one device batch (differentiable), the VQ
        state after its EMA step (None without the learned VQ))."""
        (units, mel), commit, vq_state = self.finalize(batch, generator), 0.0, None
        if self._vq is not None:
            units, _, commit, vq_state = self._vq(self.vq_state, units, train=True)
        elif self.quantizer is not None:
            units = self.quantizer(units)
        loss = self.system.loss(units, mel, generator, spk_id=batch.get("spk_id"),
                                aug_shift=batch.get("aug_shift"))
        return loss + commit, vq_state

    def loss(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The training loss of one device batch (differentiable)."""
        return self.loss_and_vq_state(batch, generator)[0]

    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One micro-step from one device batch (an update on every
        `gradient_accumulation_steps`-th); returns the loss and this
        batch's gradient global norm (before clipping) as device scalars."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, vq_state = self.loss_and_vq_state(batch, generator)
        loss.backward()
        if vq_state is not None:
            self.vq_state = vq_state
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

    def validate_full(self, val_loader, generator, logger=None, vocoder=None,
                      max_batches: int = 2) -> Dict[str, float]:
        """Validation loss on the live weights over `max_batches` batches
        (the units as evaluation sees them), and on the first the sampler's
        mean |mel - gt| (the config's `common.infer.method`; the port's
        sampler raises for one it has not ported); with a logger, the
        spectrogram triptych of its first item and, given a `vocoder`
        (`Vocoder`), that item's audio."""
        losses, metrics = [], {}
        for bi, batch in enumerate(val_loader):
            if bi >= max_batches:
                break
            batch = self.device_put_batch(batch)
            with torch.no_grad():
                units = self._quantized(batch["units"])
                losses.append(float(self.system.loss(units, batch["mel"], generator, spk_id=batch.get("spk_id"))))
            if bi == 0:
                mel = self.validate(batch, generator)
                metrics["val/mel_abs_err"] = float((mel - batch["mel"]).abs().mean())
                if logger is not None:
                    logger.log_spec_comparison(self.step, "val/spec", mel[0].float().cpu().numpy(),
                                               batch["mel"][0].float().cpu().numpy())
                    if vocoder is not None:
                        with torch.no_grad():
                            wav = vocoder.infer(mel[:1])
                        logger.log_audio(self.step, "val/audio", wav[0].float().cpu().numpy(),
                                         vocoder.vocoder_sample_rate)
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
        if self.vq_state is not None:
            # the learned codebook beside the model, as the reference keeps
            # `model_<step>_semantic_codebook.pt`
            torch.save({k: v.cpu() for k, v in self.vq_state._asdict().items()},
                       f"{tcfg.expdir}/model_{self.step}_semantic_codebook.ckpt")

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

    def _snap_flops(self, batch) -> float:
        """K6's products in a step (the counter cannot see the kernel)."""
        if isinstance(self.quantizer, EuclideanCodebook) and self.quantizer.codebook.is_cuda:
            K, D = self.quantizer.codebook.shape
            frames = batch["unit_idx"].numel() if "unit_idx" in batch else batch["units"][..., 0].numel()
            return 2.0 * frames * K * D
        return 0.0

    # -- the epoch loop --------------------------------------------------------

    def train(self, loader, val_loader=None, max_steps: Optional[int] = None, logger=None, shutdown=None):
        """Epoch loop: SIGTERM/SIGINT checkpoints once and returns
        (train/signals.py); a save every `interval_val` steps and at
        `max_steps`; the `Config.debug` checks after each step."""
        tcfg = self.cfg.diffusion.train
        dcfg = self.cfg.debug
        last_t = time.time()
        counter = FlopsByShape(self.system.module)
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
                    generator = step_generator(tcfg.seed, self.step, self.device)
                    metrics, flops = counter.step(device_batch, lambda: self.train_step(device_batch, generator),
                                                  self._snap_flops(device_batch))
                    self._batch_in_epoch += 1
                    check_step(dcfg, self.step, dict(self.system.module.named_parameters()), metrics["loss"],
                               batch=device_batch, expdir=tcfg.expdir)
                    if self.step % tcfg.interval_log == 0 and logger is not None:
                        dt = time.time() - last_t
                        last_t = time.time()
                        steps_per_sec = tcfg.interval_log / max(dt, 1e-9)
                        log = {
                            "train/loss": float(metrics["loss"]),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/steps_per_sec": steps_per_sec,
                            "train/samples_per_sec": steps_per_sec * batch_size,
                        }
                        mfu = step_mfu(flops, steps_per_sec, self.device)
                        if mfu is not None:
                            log["train/mfu"] = mfu
                        logger.log(self.step, log)
                    if self.step % tcfg.interval_val == 0:
                        self.save()
                        if val_loader is not None:
                            self.validate_full(val_loader, step_generator(tcfg.seed, self.step, self.device, 1),
                                               logger=logger)
                    if max_steps and self.step >= max_steps:
                        self.save()
                        return
