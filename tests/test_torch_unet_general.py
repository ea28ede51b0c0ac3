"""The general denoiser's blocks and `UNet1DCondition` against the JAX package.

Each ported block of `models/diffusion/blocks.py` is held to its flax
counterpart in f32 at atol 5e-5 / rtol 1e-4 (the JAX block tests'
tolerance, tests/test_unet_blocks.py), from the flax parameters (perturbed
away from their initial zeros and ones) moved over leaf by leaf with the
converter.  The whole `UNet1DCondition` at tiny widths with
attn_impl="pallas" is held to flax with attn_impl="pallas" (K5 in interpret
mode) at atol 2e-4 / rtol 1e-3 (tests/test_unit2mel_import.py).  The rest of
the block zoo and the conditioning inputs are held to JAX in
tests/test_torch_unet_zoo_blocks.py and tests/test_torch_unet_zoo_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.models.diffusion import blocks as jbl
from latent_diffusion_speech_tpu.models.diffusion.unet1d_condition import UNet1DCondition as JUNet1DCondition
from latent_diffusion_speech_tpu.models.diffusion.unet1d_condition import (
    UNet1DConditionConfig as JUNet1DConditionConfig,
)
from latent_diffusion_speech_tpu.models.diffusion.unet1d_condition import _timesteps_embedding
from latent_diffusion_speech_tpu_torch.convert import _convert
from latent_diffusion_speech_tpu_torch.models.diffusion import blocks as bl
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d_condition import (
    UNet1DCondition,
    UNet1DConditionConfig,
    timesteps_embedding,
)

B, T, E = 2, 8, 32  # batch, frames, time-embedding width


def _perturbed(params, seed=0):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.1 * r.standard_normal(p.shape).astype(np.float32),
                                  params)


def _to_jax(a):
    if isinstance(a, tuple):
        return tuple(_to_jax(x) for x in a)
    return None if a is None else jnp.asarray(a)


def _to_torch(a):
    if isinstance(a, tuple):
        return tuple(_to_torch(x) for x in a)
    return None if a is None else torch.from_numpy(a)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor) else out)]


def _x(rng, c, t=T):
    return rng.standard_normal((B, t, c)).astype(np.float32)


def _cases(rng):
    """name -> (flax module, torch module, call args as numpy / None / tuples)."""
    temb = rng.standard_normal((B, E)).astype(np.float32)
    ctx = rng.standard_normal((B, 5, 12)).astype(np.float32)
    bias = rng.standard_normal((B, 1, 1, 5)).astype(np.float32)
    ss = dict(resnet_groups=8, resnet_time_scale_shift="scale_shift")
    skips = (_x(rng, 8), _x(rng, 16), _x(rng, 16))  # popped from the end: 16, 16, then in_channels 8
    return {
        "resnet_default": (jbl.ResnetBlock1DFull(24, E, groups=8), bl.ResnetBlock1DFull(16, 24, E, groups=8),
                           (_x(rng, 16), temb)),
        "resnet_scale_shift": (
            jbl.ResnetBlock1DFull(16, E, groups=8, eps=1e-5, time_embedding_norm="scale_shift"),
            bl.ResnetBlock1DFull(16, 16, E, groups=8, eps=1e-5, time_embedding_norm="scale_shift"),
            (_x(rng, 16), temb)),
        "resnet_forced_bias_free_shortcut": (
            jbl.ResnetBlock1DFull(16, E, groups=8, skip_time_act=True, output_scale_factor=2.0,
                                  use_in_shortcut=True, conv_shortcut_bias=False),
            bl.ResnetBlock1DFull(16, 16, E, groups=8, skip_time_act=True, output_scale_factor=2.0,
                                 use_in_shortcut=True, conv_shortcut_bias=False),
            (_x(rng, 16), temb)),
        "downsample_padding_1": (jbl.ConvDownsample1D(24), bl.ConvDownsample1D(16, 24), (_x(rng, 16),)),
        "downsample_padding_0": (jbl.ConvDownsample1D(24, padding=0), bl.ConvDownsample1D(16, 24, padding=0),
                                 (_x(rng, 16),)),
        "upsample": (jbl.ConvUpsample1D(24), bl.ConvUpsample1D(16, 24), (_x(rng, 16),)),
        "cross_attention_self": (jbl.CrossAttention1D(16, 2, 8), bl.CrossAttention1D(16, 2, 8), (_x(rng, 16),)),
        "cross_attention_context_bias": (
            jbl.CrossAttention1D(16, 2, 8, cross_attention_dim=12, bias=True, attn_impl="pallas"),
            bl.CrossAttention1D(16, 2, 8, cross_attention_dim=12, bias=True, attn_impl="pallas"),
            (_x(rng, 16), ctx, bias)),
        "geglu": (jbl.GEGLU1D(32), bl.GEGLU1D(16, 32), (_x(rng, 16),)),
        "gelu_proj": (jbl.GELUProj1D(32), bl.GELUProj1D(16, 32), (_x(rng, 16),)),
        "feed_forward_geglu": (jbl.FeedForward1D(16), bl.FeedForward1D(16), (_x(rng, 16),)),
        "feed_forward_gelu": (jbl.FeedForward1D(16, activation_fn="gelu"),
                              bl.FeedForward1D(16, activation_fn="gelu"), (_x(rng, 16),)),
        "basic_transformer_block": (
            jbl.BasicTransformerBlock1D(16, 2, 8, cross_attention_dim=16, only_cross_attention=True),
            bl.BasicTransformerBlock1D(16, 2, 8, cross_attention_dim=16, only_cross_attention=True),
            (_x(rng, 16),)),
        "basic_transformer_block_cross": (
            jbl.BasicTransformerBlock1D(16, 2, 8, cross_attention_dim=12),
            bl.BasicTransformerBlock1D(16, 2, 8, cross_attention_dim=12),
            (_x(rng, 16), ctx, None, bias)),
        "transformer": (
            jbl.Transformer1D(2, 8, 16, num_layers=2, cross_attention_dim=16, norm_num_groups=8,
                              only_cross_attention=True),
            bl.Transformer1D(2, 8, 16, num_layers=2, cross_attention_dim=16, norm_num_groups=8,
                             only_cross_attention=True),
            (_x(rng, 16),)),
        "down_block": (jbl.DownBlock1D(24, E, num_layers=2, **ss), bl.DownBlock1D(16, 24, E, num_layers=2, **ss),
                       (_x(rng, 16), temb)),
        "cross_attn_down_block": (
            jbl.CrossAttnDownBlock1D(24, E, num_layers=2, num_attention_heads=2, cross_attention_dim=24,
                                     only_cross_attention=True, **ss),
            bl.CrossAttnDownBlock1D(16, 24, E, num_layers=2, num_attention_heads=2, cross_attention_dim=24,
                                    only_cross_attention=True, **ss),
            (_x(rng, 16), temb)),
        "mid_block_cross_attn": (
            jbl.MidBlock1DCrossAttn(16, E, num_attention_heads=2, cross_attention_dim=16,
                                    only_cross_attention=True, **ss),
            bl.MidBlock1DCrossAttn(16, E, num_attention_heads=2, cross_attention_dim=16,
                                   only_cross_attention=True, **ss),
            (_x(rng, 16), temb)),
        "up_block": (jbl.UpBlock1D(16, E, num_layers=3, **ss), bl.UpBlock1D(8, 24, 16, E, num_layers=3, **ss),
                     (_x(rng, 24), skips, temb)),
        "cross_attn_up_block": (
            jbl.CrossAttnUpBlock1D(16, E, num_layers=3, num_attention_heads=2, cross_attention_dim=16,
                                   only_cross_attention=True, **ss),
            bl.CrossAttnUpBlock1D(8, 24, 16, E, num_layers=3, num_attention_heads=2, cross_attention_dim=16,
                                  only_cross_attention=True, **ss),
            (_x(rng, 24), skips, temb)),
    }


CASES = sorted(_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", CASES)
def test_block_matches_flax(name):
    jmod, tmod, args = _cases(np.random.default_rng(0))[name]
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *_to_jax(args))["params"])
    tmod.load_state_dict(_convert(params))
    ref = jmod.apply({"params": params}, *_to_jax(args))
    with torch.no_grad():
        got = tmod(*_to_torch(args))
    ref, got = _flat(ref), _flat(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["swish", "silu", "gelu", "mish", "relu"])
def test_activation_matches_flax(name):
    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(bl.get_activation(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jbl.get_activation(name)(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("flip,shift,dim", [(True, 0, 16), (False, 1, 15)])
def test_timesteps_embedding_matches(flip, shift, dim):
    t = np.array([0.0, 3.5, 999.0], np.float32)
    np.testing.assert_allclose(timesteps_embedding(torch.from_numpy(t), dim, flip, shift).numpy(),
                               np.asarray(_timesteps_embedding(jnp.asarray(t), dim, flip, shift)), atol=1e-5)


# Unit2Mel's effective general layout at tiny widths: three levels, so the
# down, mid and up paths each hold attention at two widths
TINY = dict(in_channels=16, out_channels=6, block_out_channels=(16, 24, 32),
            down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, norm_num_groups=8, cross_attention_dim=(16, 24, 32), attention_head_dim=2,
            only_cross_attention=True, resnet_time_scale_shift="scale_shift")


def test_unet1d_condition_pallas_matches_flax(rng):
    """One forward with K5 in both packages (interpret mode in JAX); the
    flax parameters come from an attn_impl='xla' init (the same tree)."""
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    t = np.array([3, 711], np.int32)
    params = _perturbed(JUNet1DCondition(JUNet1DConditionConfig(**TINY)).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"])
    jmod = JUNet1DCondition(JUNet1DConditionConfig(**TINY), attn_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda p, x, t: jmod.apply({"params": p}, x, t))(params, jnp.asarray(x), jnp.asarray(t))
        ref = np.asarray(ref)
    model = UNet1DCondition(UNet1DConditionConfig(**TINY), attn_impl="pallas")
    model.load_state_dict(_convert(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.shape == (2, 16, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_unet1d_condition_rejects_bad_lengths():
    model = UNet1DCondition(UNet1DConditionConfig(**TINY))
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros((1, 6, 16)), torch.tensor([1]))
