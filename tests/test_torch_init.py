"""The port's seeded weights against the JAX modules' flax initialisers.

For the RoFormer, `Unit2Mel` (flagship and general denoiser), the vocoder
`Generator`, the `VAEEncoder`, the codec trainer's discriminator bank
(2-D convolutions and grouped 1-D ones, flax's `nn.Conv` defaults) and the
unit encoders (HuBERT-soft at its only width; XLSR and w2v-BERT small, the
latter's relative-key table at flax's N(0, 0.02)), at small widths, each
seeded leaf of the
port is held to the leaf of the same name in the JAX module's seeded tree
(names moved over with `convert.py`): every bias and norm offset exactly
0, every norm scale exactly 1, the standard deviation of every other leaf
with at least 4096 entries within 10% of the JAX leaf's, and every
embedding at N(0, 1/C) (within 30% of 1/sqrt(C) from 64 entries up).  The
draws cannot be the same (torch's generator against `jax.random`), so the
statistics are compared, not the values.  At the shipped width, the seeded
RoFormer's first loss (on the CPU, one batch, no dropout) lies within 1.0 of
the seeded JAX RoFormer's on the same batch.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from latent_diffusion_speech_tpu import config as j_config
from latent_diffusion_speech_tpu.models import hubert as j_hubert
from latent_diffusion_speech_tpu.models import w2vbert as j_w2vbert
from latent_diffusion_speech_tpu.models import wav2vec2 as j_wav2vec2
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN as JHifiVAEGAN
from latent_diffusion_speech_tpu.models.vaegan.discriminators import DiscriminatorBank as JDiscriminatorBank
from latent_diffusion_speech_tpu.train.lm_trainer import roformer_config_from as j_roformer_config_from
from latent_diffusion_speech_tpu_torch import config, convert
from latent_diffusion_speech_tpu_torch.models import hubert, units, w2vbert, wav2vec2
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"
STACK = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128)
UNIT2MEL = dict(input_channel=64, n_spk=8, out_dims=16, n_hidden=64, block_out_channels=(64, 96), n_heads=4)
VAEGAN = dict(sampling_rate=8000, inter_channels=16, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 2),
              upsample_initial_channel=64, upsample_kernel_sizes=(8, 4))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _roformer():
    jcfg = JRoformerConfig(encoder=JStackConfig(num_hidden_layers=2, **STACK),
                           decoder=JStackConfig(num_hidden_layers=1, **STACK), semantic_kmeans_num=300, n_spk=4)
    cfg = RoformerConfig(encoder=StackConfig(num_hidden_layers=2, **STACK),
                         decoder=StackConfig(num_hidden_layers=1, **STACK), semantic_kmeans_num=300, n_spk=4)
    jtree = convert.roformer_from_jax(_np(JRoformerSystem(jcfg, dtype=jnp.float32, seed=0).params))
    return jtree, RoformerSystem(cfg, dtype=torch.float32, device="cpu").module


def _unit2mel(denoiser):
    jtree = convert.unit2mel_from_jax(_np(JUnit2MelSystem(JUnit2MelConfig(denoiser=denoiser, **UNIT2MEL)).params))
    return jtree, Unit2MelSystem(Unit2MelConfig(denoiser=denoiser, **UNIT2MEL), device="cpu").module


def _codec(part):
    jcodec = JHifiVAEGAN.random_init(JVAEGANConfig(**VAEGAN))
    codec = HifiVAEGAN.random_init(VAEGANConfig(**VAEGAN), device="cpu")
    if part == "generator":
        return convert.generator_from_jax(_np(jcodec.generator_params)), codec.generator
    return convert.encoder_from_jax(_np(jcodec.encoder_params)), codec.encoder


def _bank():
    """The codec trainer's seeded bank (one STFT scale, one period) against
    the flax bank's init."""
    scales, periods = ((128, 32, 128),), (2,)
    jbank = JDiscriminatorBank(periods=periods, stft_scales=scales)
    jparams = jax.jit(jbank.init)(jax.random.PRNGKey(0), jnp.zeros((1, 512)))["params"]
    jtree = convert.discriminator_bank_from_jax(_np(jparams))
    trainer = CodecTrainer(VAEGANConfig(**VAEGAN), disc_scales=scales, disc_periods=periods, device="cpu")
    return jtree, trainer.disc


XLSR = dict(hidden_size=64, num_hidden_layers=2, intermediate_size=128, num_attention_heads=4, conv_dim=(32, 32, 32),
            conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
W2VBERT = dict(hidden_size=256, num_hidden_layers=1, intermediate_size=256, num_attention_heads=2)


def _encoder(name):
    """The JAX module's seeded tree against the port's seeded encoder
    (`models/units.py::_built`, as `UnitsEncoder` seeds it)."""
    if name == "hubert":
        jm, probe, factory, to = j_hubert.HubertSoft(), jnp.zeros((1, 960)), hubert.HubertSoft, convert.hubert_from_jax
    elif name == "xlsr":
        jm, probe = j_wav2vec2.Wav2Vec2Encoder(j_wav2vec2.Wav2Vec2Config(**XLSR)), jnp.zeros((1, 1600))
        factory, to = lambda: wav2vec2.Wav2Vec2Encoder(wav2vec2.Wav2Vec2Config(**XLSR)), convert.wav2vec2_from_jax
    else:
        jm, probe = j_w2vbert.W2vBertModel(j_w2vbert.W2vBertConfig(**W2VBERT)), jnp.zeros((1, 4, 160))
        factory, to = lambda: w2vbert.W2vBertModel(w2vbert.W2vBertConfig(**W2VBERT)), convert.w2vbert_from_jax
    jtree = to(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), probe)["params"]))
    return jtree, units._built(factory, torch.device("cpu"), None, 0, torch.float32)


MODULES = {
    "roformer": _roformer,
    "unit2mel_flagship": lambda: _unit2mel("flagship"),
    "unit2mel_general": lambda: _unit2mel("general"),
    "vocoder_generator": lambda: _codec("generator"),
    "vaegan_encoder": lambda: _codec("encoder"),
    "discriminator_bank": _bank,
    "hubert_soft": lambda: _encoder("hubert"),
    "xlsr": lambda: _encoder("xlsr"),
    "w2vbert": lambda: _encoder("w2vbert"),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_seeded_leaves_follow_the_flax_initialisers(name):
    jtree, module = MODULES[name]()
    mine = {k: v.detach().float() for k, v in module.state_dict().items()}
    assert sorted(mine) == sorted(jtree)
    norms = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, (nn.LayerNorm, nn.GroupNorm))}
    embeds = {f"{n}.weight": m.embedding_dim for n, m in module.named_modules() if isinstance(m, nn.Embedding)}
    checked = 0
    for key, theirs in jtree.items():
        got = mine[key]
        if key.endswith("bias"):
            assert not got.any() and not theirs.any(), key
        elif key in norms:
            assert (got == 1).all() and (theirs == 1).all(), key
        else:
            if key in embeds and got.numel() >= 64:
                assert abs(got.std().item() * embeds[key] ** 0.5 - 1.0) < 0.3, (key, got.std().item())
            if got.numel() >= 4096:
                ratio = got.std().item() / theirs.std().item()
                assert abs(ratio - 1.0) < 0.1, (key, ratio)
                checked += 1
    assert checked >= 4


def test_seeded_roformer_first_loss_matches_jax_at_the_shipped_width():
    jcfg = j_roformer_config_from(j_config.load_config(CONFIG))
    cfg = roformer_config_from(config.load_config(CONFIG))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(0)
    B, L, S = 4, 40, 96
    phone = rng.integers(1, 60, (B, L)).astype(np.int32)
    tone = rng.integers(0, 5, (B, L)).astype(np.int32)
    semantic = rng.integers(0, cfg.semantic_kmeans_num, (B, S)).astype(np.int32)
    spk = np.repeat(rng.integers(1, cfg.n_spk, (B, 1)).astype(np.int32), L, axis=1)
    ones_l, ones_s = np.ones((B, L), np.int32), np.ones((B, S), np.int32)
    jlm = JRoformerSystem(jcfg, dtype=jnp.float32, seed=0)
    ref = float(jlm.loss(jlm.params, phone, tone, semantic, semantic, spk_id=spk,
                         encoder_attention_mask=ones_l, attention_mask=ones_s))
    lm = RoformerSystem(cfg, dtype=torch.float32, device="cpu")
    batch = {"phone": phone, "tone": tone, "semantic": semantic, "labels": semantic, "spk_id": spk,
             "encoder_attention_mask": ones_l, "attention_mask": ones_s}
    with torch.no_grad():
        got = lm.loss({k: torch.from_numpy(v.copy()).long() for k, v in batch.items()}).item()
    assert np.isfinite(ref) and abs(got - ref) < 1.0, (got, ref)
