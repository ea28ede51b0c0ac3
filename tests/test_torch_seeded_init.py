"""`ops/layers.py::built_for_init` skips torch's default draws of the layers
that `init_weights` draws anew.  Each seeded module family is built both
ways, the skipped tensors poisoned with NaN: the state dicts must be equal
bit for bit, so every skipped tensor is overwritten and nothing else moves."""

from __future__ import annotations

import math

import pytest
import torch

from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel, Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.llama import Llama, LlamaConfig
from latent_diffusion_speech_tpu_torch.models.lm.roformer import Roformer, RoformerConfig, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.codec import CONV_STD, HifiVAEGAN
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.discriminators import DiscriminatorBank
from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder
from latent_diffusion_speech_tpu_torch.ops import layers
from latent_diffusion_speech_tpu_torch.ops.layers import built_for_init, init_weights, seeded
from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer

U2M = dict(input_channel=8, n_spk=4, out_dims=4, n_hidden=16, n_layers=1, block_out_channels=(32, 32, 32, 32),
           n_heads=2, timesteps=20, k_step=20)
# the block zoo of the general denoiser: every down and up block type and the three mid blocks
ZOO = {
    "attn": (("ResnetDownsampleBlock2D", "AttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "DownBlock2D"),
             ("UpBlock2D", "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "ResnetUpsampleBlock2D"),
             "UNetMidBlock2DSimpleCrossAttn"),
    "skip": (("AttnSkipDownBlock2D", "SkipDownBlock2D", "AttnSkipDownBlock2D", "SkipDownBlock2D"),
             ("SkipUpBlock2D", "AttnSkipUpBlock2D", "SkipUpBlock2D", "AttnSkipUpBlock2D"), "UNetMidBlock2D"),
    "encdec": (("DownEncoderBlock2D", "AttnDownEncoderBlock2D", "DownEncoderBlock2D", "AttnDownEncoderBlock2D"),
               ("AttnUpDecoderBlock2D", "UpDecoderBlock2D", "AttnUpDecoderBlock2D", "UpDecoderBlock2D"),
               "UNetMidBlock2D"),
    "k": (("KDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D"),
          ("KCrossAttnUpBlock2D",) * 3 + ("KUpBlock2D",), None),
}
STACK = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=24)
LLAMA = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=2, intermediate_size=48, semantic_kmeans_num=32)
CODEC = VAEGANConfig(inter_channels=8, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                     upsample_rates=(4, 4), upsample_initial_channel=32, upsample_kernel_sizes=(8, 8))


class _Poison(layers._NoDefaultInit):
    """Fills each skipped tensor with NaN, so one left as built shows."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.SKIPPED:
            tensor = args[0] if args else kwargs["tensor"]
            with torch.no_grad():
                return tensor.fill_(math.nan)
        return func(*args, **kwargs)


@pytest.fixture
def poisoned(monkeypatch):
    monkeypatch.setattr(layers, "_NoDefaultInit", _Poison)


def _default(factory, seed=0, **kw):
    """The construction without the skip: torch's draws, then init_weights."""
    with torch.random.fork_rng(devices=[]):
        module = factory()
    return init_weights(module, torch.Generator().manual_seed(seed), **kw)


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


FAMILIES = {
    "unit2mel_flagship": lambda: Unit2Mel(Unit2MelConfig(**U2M)),
    **{f"unit2mel_general_{name}": (lambda d=d, u=u, m=m: Unit2Mel(Unit2MelConfig(
        **U2M, denoiser="general", down_block_types=d, up_block_types=u, mid_block_type=m)))
       for name, (d, u, m) in ZOO.items()},
    "unit2mel_general": lambda: Unit2Mel(Unit2MelConfig(**U2M, denoiser="general")),
    "roformer": lambda: Roformer(RoformerConfig(encoder=StackConfig(**STACK), decoder=StackConfig(**STACK),
                                                semantic_kmeans_num=32, n_spk=4)),
    "llama": lambda: Llama(LlamaConfig(**LLAMA)),
    "llama_moe": lambda: Llama(LlamaConfig(**LLAMA, moe_experts=4)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_seeded_equals_the_default_construction(family, poisoned):
    """`seeded` (through built_for_init) against torch's draws + init_weights."""
    factory = FAMILIES[family]
    _assert_same(seeded(factory, 3).state_dict(), _default(factory, 3).state_dict())


def test_unit2mel_system_weights_unchanged(poisoned):
    got = Unit2MelSystem(Unit2MelConfig(**U2M), device="cpu", seed=5).module.state_dict()
    _assert_same(got, _default(lambda: Unit2Mel(Unit2MelConfig(**U2M)), 5).state_dict())


def test_codec_pair_and_bank_unchanged(poisoned):
    """HifiVAEGAN (the generator, then the encoder, from one generator) and
    the discriminator bank, without conv_std, as CodecTrainer draws it."""
    cfg = CODEC
    codec = HifiVAEGAN(cfg, device="cpu", seed=2)
    with torch.random.fork_rng(devices=[]):
        generator, encoder = Generator(cfg), VAEEncoder(cfg)
    draws = torch.Generator().manual_seed(2)
    init_weights(generator, draws, conv_std=CONV_STD)
    init_weights(encoder, draws, conv_std=CONV_STD)
    _assert_same(codec.generator.state_dict(), generator.state_dict())
    _assert_same(codec.encoder.state_dict(), encoder.state_dict())

    def bank():
        return DiscriminatorBank(periods=(2, 3), stft_scales=((128, 32, 128),))

    with built_for_init():
        got = bank()
    _assert_same(init_weights(got, torch.Generator().manual_seed(4)).state_dict(), _default(bank, 4).state_dict())


def test_codec_trainer_weights_unchanged(poisoned, tmp_path):
    cfg = CODEC
    t = CodecTrainer(cfg, expdir=str(tmp_path), device="cpu", disc_scales=((128, 32, 128),), disc_periods=(2,),
                     seed=1)
    with torch.random.fork_rng(devices=[]):
        encoder, generator = VAEEncoder(cfg), Generator(cfg)
        disc = DiscriminatorBank(periods=(2,), stft_scales=((128, 32, 128),))
    draws = torch.Generator().manual_seed(1)
    for module, kw in ((encoder, dict(conv_std=CONV_STD)), (generator, dict(conv_std=CONV_STD)), (disc, {})):
        init_weights(module, draws, **kw)
    _assert_same(t.encoder.state_dict(), encoder.state_dict())
    _assert_same(t.generator.state_dict(), generator.state_dict())
    _assert_same(t.disc.state_dict(), disc.state_dict())


def test_global_rng_untouched_and_skip_scoped():
    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    with built_for_init():
        inside = torch.nn.Linear(4, 4)
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.manual_seed(0)
    after = torch.nn.Linear(4, 4)  # outside the block: torch's own draws again
    torch.manual_seed(0)
    assert torch.equal(after.weight, torch.nn.Linear(4, 4).weight)
    assert inside.weight.shape == (4, 4)
