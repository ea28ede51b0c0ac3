"""HiFi-VAEGAN codec trainer: alternating discriminator and generator steps.

Counterpart of `latent_diffusion_speech_tpu/train/codec_trainer.py`, on one
device or data-parallel over every process (the JAX trainer spreads over
every device, `build_mesh()` without the config), in f32 (TF32 off, as the
other trainers):
* the discriminator step reconstructs the batch without the VQ (as the JAX
  step does, so with `use_vq` the discriminator sees unquantised fakes),
  then steps on the LSGAN loss of real against the detached fakes;
* the generator step reconstructs again (encoder -> optional learned
  `VectorQuantize` -> generator) and steps on adversarial + fm x feature
  matching + kl x KL + mel x RSS(512, 1024, 2048) + the VQ's commitment
  loss, the discriminator's weights held fixed; the VQ's EMA state moves
  with each generator step, and its projections never train;
* each network has its own `AdamW(lr, betas (0.8, 0.99), weight decay
  1e-4)` with a constant rate and no clipping (optax.adamw's defaults);
* `save` writes the generator and discriminator weights as one
  `model_<step>.ckpt` (`{"gen": {"encoder", "generator"}, "disc"}`) and
  `resume` reads them back; neither keeps the optimizers' or the VQ's
  state, as in the JAX trainer (ROADMAP.md R9).
The encoder's latent noise of each step is drawn from a generator the caller
passes; `train_step` draws it on the CPU and moves it over, so a step on the
card and the same step on the CPU see the same noise.  `device` (None means
`cuda`) is a rank's device.  Under data parallelism (`mesh`, default
`build_mesh()`) each rank holds its rows of the global batch (the same shape
on every rank), the noise is drawn for the global batch and each rank keeps
its rows, the VQ's EMA statistics are summed over the ranks, and both steps
average their gradients and losses over the ranks (one all-reduce each);
`save` writes on rank 0, then a barrier.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.models.vaegan.codec import CONV_STD
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.discriminators import DiscriminatorBank
from latent_diffusion_speech_tpu_torch.models.vaegan.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
    rss_loss,
)
from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder
from latent_diffusion_speech_tpu_torch.ops.layers import built_for_init, init_weights, no_tf32, resolve_device
from latent_diffusion_speech_tpu_torch.parallel import mesh as rows
from latent_diffusion_speech_tpu_torch.parallel.dist import is_main_process, sync_global_devices
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, RowGenerator, build_mesh
from latent_diffusion_speech_tpu_torch.parallel.multihost import gather_to_host, global_shard_batch
from latent_diffusion_speech_tpu_torch.quantize.codebook import VectorQuantize
from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step, load_checkpoint, save_checkpoint
from latent_diffusion_speech_tpu_torch.train.optim import AdamW

__all__ = ["CodecTrainer"]


class CodecTrainer:
    def __init__(
        self,
        cfg: Optional[VAEGANConfig] = None,
        lr: float = 2e-4,
        kl_weight: float = 0.01,
        mel_weight: float = 45.0,
        fm_weight: float = 1.0,
        use_vq: bool = False,
        vq_codebook_size: int = 4096,
        expdir: str = "exp/codec",
        seed: int = 0,
        disc_scales=((1024, 256, 1024), (512, 128, 512)),
        disc_periods=(2, 3, 5, 7, 11),
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        """Seeded weights (flax's initialisers, from one CPU generator
        seeded with `seed`: the encoder, the generator, the bank, then the
        VQ state).  device: None means `cuda` (raises without a card).
        mesh: the data-parallel mesh (default: every process)."""
        self.cfg = cfg or VAEGANConfig()
        self.mesh = mesh if mesh is not None else build_mesh()
        self.device = resolve_device(device)
        no_tf32()  # f32 as the JAX trainer computes
        self.expdir = expdir
        self.kl_weight, self.mel_weight, self.fm_weight = kl_weight, mel_weight, fm_weight
        draws = torch.Generator().manual_seed(seed)
        with built_for_init():
            encoder, generator = VAEEncoder(self.cfg), Generator(self.cfg)
            disc = DiscriminatorBank(periods=disc_periods, stft_scales=disc_scales)
        self.encoder = init_weights(encoder, draws, conv_std=CONV_STD).to(self.device).train()
        self.generator = init_weights(generator, draws, conv_std=CONV_STD).to(self.device).train()
        self.disc = init_weights(disc, draws).to(self.device).train()
        self.vq = VectorQuantize(self.cfg.inter_channels, vq_codebook_size) if use_vq else None
        self.vq_state = self.vq.init(draws, self.device) if self.vq is not None else None
        self.gen_params = list(self.encoder.parameters()) + list(self.generator.parameters())
        self.gen_opt = AdamW(self.gen_params, lr, betas=(0.8, 0.99))
        self.disc_opt = AdamW(self.disc.parameters(), lr, betas=(0.8, 0.99))
        self.gen_opt.mesh = self.disc_opt.mesh = self.mesh
        self.step = 0

    def _reconstruct(self, audio: torch.Tensor, eps: torch.Tensor, vq: bool):
        """(fake audio, m, logs, commitment loss, new VQ state or None)."""
        _, m, logs = self.encoder(audio, sample=False)
        z = m + eps * torch.exp(logs)
        commit, vq_state = 0.0, None
        if vq and self.vq is not None:
            z, _, commit, vq_state = self.vq(self.vq_state, z, train=True,
                                             mesh=self.mesh if self.mesh.group is not None else None)
        return self.generator(z), m, logs, commit, vq_state

    def latent_noise(self, audio: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """One step's encoder noise, (B, T // hop, inter_channels), drawn
        from a CPU `generator` (by rows under a mesh) and moved to the
        trainer's device."""
        shape = (audio.shape[0], audio.shape[-1] // self.cfg.hop_size, self.cfg.inter_channels)
        if self.mesh.group is not None:
            generator = RowGenerator(generator, self.mesh)
        return rows.randn(shape, generator).to(self.device)

    def disc_step(self, audio: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """One discriminator update; returns its loss (a device scalar)."""
        with torch.no_grad():
            fake = self._reconstruct(audio, eps, vq=False)[0]
        self.disc_opt.zero_grad()
        real_logits, _ = self.disc(audio)
        fake_logits, _ = self.disc(fake)
        loss, _ = discriminator_loss(real_logits, fake_logits)
        loss.backward()
        loss = loss.detach().clone()
        self.disc_opt.apply_update(reduce=[loss])
        return loss

    def gen_step(self, audio: torch.Tensor, eps: torch.Tensor):
        """One generator (and encoder) update against the fixed
        discriminator; returns (total loss, {"gen/adv", "gen/fm", "gen/kl",
        "gen/mel"}) as device scalars."""
        self.gen_opt.zero_grad()
        self.disc.requires_grad_(False)
        try:
            fake, m, logs, commit, vq_state = self._reconstruct(audio, eps, vq=True)
            fake_logits, fake_fmaps = self.disc(fake)
            _, real_fmaps = self.disc(audio)
            adv, _ = generator_loss(fake_logits)
            fm = feature_loss(real_fmaps, fake_fmaps)
            kl = kl_loss(logs, m)
            mel = rss_loss(fake, audio, scales=(512, 1024, 2048))
            total = adv + self.fm_weight * fm + self.kl_weight * kl + self.mel_weight * mel + commit
            total.backward()
        finally:
            self.disc.requires_grad_(True)
        aux = {"gen/adv": adv, "gen/fm": fm, "gen/kl": kl, "gen/mel": mel}
        total, aux = total.detach().clone(), {k: v.detach().clone() for k, v in aux.items()}
        self.gen_opt.apply_update(reduce=[total, *aux.values()])
        if vq_state is not None:
            self.vq_state = vq_state
        return total, aux

    def train_step(self, audio, generator: torch.Generator) -> Dict[str, float]:
        """One alternating D/G step on (B, T) audio (T a hop multiple), the
        two steps' latent noise drawn in turn from the CPU `generator`."""
        audio = global_shard_batch(self.mesh, {"audio": torch.as_tensor(np.asarray(audio, np.float32))})["audio"]
        audio = audio.to(self.device)
        eps_d = self.latent_noise(audio, generator)
        eps_g = self.latent_noise(audio, generator)
        d_loss = self.disc_step(audio, eps_d)
        g_loss, aux = self.gen_step(audio, eps_g)
        self.step += 1
        return {"disc/loss": float(d_loss), "gen/loss": float(g_loss), **{k: float(v) for k, v in aux.items()}}

    def save(self, keep: int = 4):
        """The weights, written by rank 0, then a barrier over the processes."""
        if is_main_process():
            params = {"gen": {"encoder": self.encoder.state_dict(), "generator": self.generator.state_dict()},
                      "disc": self.disc.state_dict()}
            save_checkpoint(self.expdir, self.step, gather_to_host(params), keep=keep)
        sync_global_devices("save")

    def resume(self) -> bool:
        """Load the latest checkpoint's weights; False when there is none."""
        if latest_checkpoint_step(self.expdir) is None:
            return False
        step, params, _ = load_checkpoint(self.expdir)
        self.encoder.load_state_dict(params["gen"]["encoder"])
        self.generator.load_state_dict(params["gen"]["generator"])
        self.disc.load_state_dict(params["disc"])
        self.step = step
        return True
