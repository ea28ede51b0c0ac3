"""The general denoiser's block zoo against the JAX package, block by block.

Every entry of `DOWN_BLOCK_TYPES` and `UP_BLOCK_TYPES` and the three mid
blocks, built by both packages' factories from the same arguments, and the
parts they are made of (`AdaGroupNorm1D`, the resnet's ada_group, FIR,
sde_vp and default resampling, both `cross_attention_norm`s, the added-K/V
and K attentions, `DualTransformer1D`, the FIR resamplers with a conv), are
held to the flax module in f32 at atol 5e-5 / rtol 1e-4 (the JAX block
tests' tolerance, tests/test_unet_blocks.py); the resamplers alone at 1e-6.
The blocks with cross-attention take encoder states and both attention
biases.  Parameters are drawn with numpy over the flax tree's shapes
(`jax.eval_shape` of the init: no init compiles) and moved over leaf by
leaf with the converter; the port's attention runs attn_impl="pallas" (K5's
plain version on the CPU, the biased calls the plain attention), flax's
'xla'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion import blocks as jbl
from latent_diffusion_speech_tpu_torch.convert import _convert
from latent_diffusion_speech_tpu_torch.models.diffusion import blocks as bl

B, T, E, CD, SK = 2, 8, 32, 32, 6  # batch, frames, time-embedding width, context width, skip-sample width
CIN, COUT = 32, 64


def draw(shapes, seed=0):
    """numpy parameters for a flax tree of shapes: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.01), biases N(0, 0.01), other leaves N(0, 1)."""
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (r.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * r.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * r.standard_normal(s.shape)).astype(np.float32)
        return r.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor) else out)]


def _to(a, fn):
    if isinstance(a, tuple):
        return tuple(_to(x, fn) for x in a)
    if isinstance(a, dict):
        return {k: _to(v, fn) for k, v in a.items()}
    return None if a is None else fn(a)


def _x(rng, c, t=T):
    return rng.standard_normal((B, t, c)).astype(np.float32)


def _factory_kw(t):
    k = t.startswith("K")
    return dict(resnet_groups=8, cross_attention_dim=CD, num_attention_heads=4, attention_head_dim=8,
                skip_channels=SK, resnet_act_fn="gelu" if k else "silu")


def _kv_bias(rng):
    """A bias over an added-K/V attention's keys: 5 context keys, then T."""
    return rng.standard_normal((B, 1, 1, 5 + T)).astype(np.float32)


_CROSS_DOWN = ("CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "KCrossAttnDownBlock2D")
_CROSS_UP = ("CrossAttnUpBlock2D", "SimpleCrossAttnUpBlock2D", "KCrossAttnUpBlock2D")


def _down_case(t, rng):
    kw = _factory_kw(t)
    act = kw.pop("resnet_act_fn")
    args = (t, 2, CIN, COUT, E, True, 1e-5, act)
    x, temb = _x(rng, CIN), rng.standard_normal((B, E)).astype(np.float32)
    if t in ("SkipDownBlock2D", "AttnSkipDownBlock2D"):
        call, kwargs = (x, temb), dict(skip_sample=_x(rng, SK))
    elif t in _CROSS_DOWN:
        ctx = _x(rng, CD, 5)
        bias = rng.standard_normal((B, 1, 1, T)).astype(np.float32)
        ctx_bias = rng.standard_normal((B, 1, 1, 5)).astype(np.float32)
        call, kwargs = ((x, temb, ctx, _kv_bias(rng)) if t == "SimpleCrossAttnDownBlock2D"
                        else (x, temb, ctx, bias, ctx_bias)), {}
    else:
        call, kwargs = (x, temb), {}
    ctx_kw = dict(context_dim=CD) if t in _CROSS_DOWN else {}
    return (jbl.get_down_block(*args, **kw, attn_impl="xla"),
            bl.get_down_block(*args, **kw, attn_impl="pallas", **ctx_kw), call, kwargs)


def _up_case(t, rng):
    kw = _factory_kw(t)
    act = kw.pop("resnet_act_fn")
    layers = 3 if t.startswith("K") else 2
    args = (t, layers, CIN, COUT, COUT, E, True, 1e-5, act)
    x, temb = _x(rng, COUT), rng.standard_normal((B, E)).astype(np.float32)
    skips = (_x(rng, CIN), _x(rng, COUT))  # popped from the end: COUT, then in_channels CIN
    if t.startswith("K"):
        skips = (_x(rng, COUT), _x(rng, COUT))  # the K blocks concatenate the last one up front
    extra = {}
    if t in ("SkipUpBlock2D", "AttnSkipUpBlock2D"):
        call, kwargs = (x, skips, temb), dict(skip_sample=_x(rng, SK, T // 2))
    elif t in ("UpDecoderBlock2D", "AttnUpDecoderBlock2D"):
        call, kwargs = (x, temb), {}
    elif t in _CROSS_UP:
        ctx = _x(rng, CD, 5)
        bias = rng.standard_normal((B, 1, 1, T)).astype(np.float32)
        ctx_bias = rng.standard_normal((B, 1, 1, 5)).astype(np.float32)
        call, kwargs = ((x, skips, temb, ctx, _kv_bias(rng)) if t == "SimpleCrossAttnUpBlock2D"
                        else (x, skips, temb, ctx, bias, ctx_bias)), {}
        extra["context_dim"] = CD
    else:
        call, kwargs = (x, skips, temb), {}
    return jbl.get_up_block(*args, **kw, attn_impl="xla"), bl.get_up_block(*args, **kw, attn_impl="pallas",
                                                                            **extra), call, kwargs


def _mid_case(t, rng):
    kw = dict(resnet_groups=8, num_attention_heads=4, attention_head_dim=8, cross_attention_dim=CD,
              resnet_time_scale_shift="scale_shift", cross_attention_norm="layer_norm")
    x, temb = _x(rng, COUT), rng.standard_normal((B, E)).astype(np.float32)
    ctx, ctx_bias = _x(rng, CD, 5), rng.standard_normal((B, 1, 1, 5)).astype(np.float32)
    call = {"UNetMidBlock2D": (x, temb), "UNetMidBlock2DCrossAttn": (x, temb, ctx, None, ctx_bias),
            "UNetMidBlock2DSimpleCrossAttn": (x, temb, ctx, _kv_bias(rng))}[t]
    ctx_kw = {} if t == "UNetMidBlock2D" else dict(context_dim=CD)
    return (jbl.get_mid_block(t, COUT, E, attn_impl="xla", **kw),
            bl.get_mid_block(t, COUT, E, attn_impl="pallas", **kw, **ctx_kw), call, {})


def _part_case(name, rng):
    temb = rng.standard_normal((B, E)).astype(np.float32)
    ctx = _x(rng, CD, 5)
    res = dict(groups=8, eps=1e-5)
    resample = {  # name -> (up, down, kernel)
        "resnet_fir_down": (False, True, "fir"), "resnet_fir_up": (True, False, "fir"),
        "resnet_sde_vp_down": (False, True, "sde_vp"), "resnet_sde_vp_up": (True, False, "sde_vp"),
        "resnet_avg_down": (False, True, None), "resnet_nearest_up": (True, False, None),
    }
    if name in resample:
        up, down, kernel = resample[name]
        r = dict(res, up=up, down=down, kernel=kernel, time_embedding_norm="scale_shift")
        return jbl.ResnetBlock1DFull(COUT, E, **r), bl.ResnetBlock1DFull(CIN, COUT, E, **r), (_x(rng, CIN), temb), {}
    if name == "ada_group_norm":
        return (jbl.AdaGroupNorm1D(CIN, 8, act_fn="silu"), bl.AdaGroupNorm1D(E, CIN, 8, act_fn="silu"),
                (_x(rng, CIN), temb), {})
    if name == "resnet_ada_group":
        r = dict(groups=8, groups_out=4, time_embedding_norm="ada_group", conv_shortcut_bias=False)
        return (jbl.ResnetBlock1DFull(COUT, E, **r), bl.ResnetBlock1DFull(CIN, COUT, E, **r),
                (_x(rng, CIN), temb), {})
    if name in ("cross_attention_norm_layer", "cross_attention_norm_group"):
        kind = name.rsplit("_", 1)[1] + "_norm"
        a = dict(cross_attention_dim=CD, cross_attention_norm=kind, cross_attention_norm_num_groups=8)
        return (jbl.CrossAttention1D(CIN, 4, 8, **a), bl.CrossAttention1D(CIN, 4, 8, **a, attn_impl="pallas"),
                (_x(rng, CIN), ctx), {})
    if name == "added_kv_context_group_norm":
        a = dict(norm_num_groups=8, cross_attention_norm="group_norm")
        return (jbl.AddedKVAttention1D(CIN, 4, 8, CD, **a),
                bl.AddedKVAttention1D(CIN, 4, 8, CD, **a, attn_impl="pallas", context_dim=CD),
                (_x(rng, CIN), ctx), {})
    if name == "added_kv_self_only_cross":
        a = dict(norm_num_groups=8, only_cross_attention=True)
        return (jbl.AddedKVAttention1D(CIN, 4, 8, CD, **a),
                bl.AddedKVAttention1D(CIN, 4, 8, CD, **a, attn_impl="pallas"), (_x(rng, CIN),), {})
    if name == "k_attention_self_and_cross":
        a = dict(cross_attention_dim=CD, temb_channels=E, add_self_attention=True,
                 cross_attention_norm="layer_norm", group_size=8)
        return (jbl.KAttention1D(CIN, 4, 8, **a), bl.KAttention1D(CIN, 4, 8, **a, attn_impl="pallas", context_dim=CD),
                (_x(rng, CIN), temb, ctx), {})
    if name == "dual_transformer":
        a = dict(num_layers=1, cross_attention_dim=CD, norm_num_groups=8, condition_lengths=(3, 4))
        return (jbl.DualTransformer1D(4, 8, CIN, **a), bl.DualTransformer1D(4, 8, CIN, **a),
                (_x(rng, CIN), _x(rng, CD, 7)), {})
    if name == "fir_downsample_conv":
        return (jbl.FirDownsample1D(COUT, use_conv=True), bl.FirDownsample1D(CIN, COUT, use_conv=True),
                (_x(rng, CIN),), {})
    if name == "fir_upsample_conv":
        return (jbl.FirUpsample1D(COUT, use_conv=True), bl.FirUpsample1D(CIN, COUT, use_conv=True),
                (_x(rng, CIN),), {})
    raise KeyError(name)


PARTS = ("resnet_fir_down", "resnet_fir_up", "resnet_sde_vp_down", "resnet_sde_vp_up", "resnet_avg_down",
         "resnet_nearest_up", "ada_group_norm", "resnet_ada_group", "cross_attention_norm_layer",
         "cross_attention_norm_group", "added_kv_context_group_norm", "added_kv_self_only_cross",
         "k_attention_self_and_cross", "dual_transformer", "fir_downsample_conv", "fir_upsample_conv")
CASES = ([f"down {t}" for t in bl.DOWN_BLOCK_TYPES] + [f"up {t}" for t in bl.UP_BLOCK_TYPES]
         + [f"mid {t}" for t in bl.MID_BLOCK_TYPES] + [f"part {p}" for p in PARTS])


def _case(case, rng):
    kind, name = case.split(" ")
    return {"down": _down_case, "up": _up_case, "mid": _mid_case, "part": _part_case}[kind](name, rng)


@pytest.mark.parametrize("case", CASES)
def test_block_matches_flax(case):
    jmod, tmod, args, kwargs = _case(case, np.random.default_rng(0))
    jargs, jkw = _to(args, jnp.asarray), _to(kwargs, jnp.asarray)
    params = draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs, **jkw)["params"])
    tmod.load_state_dict(_convert(params))
    ref = jmod.apply({"params": params}, *jargs, **jkw)
    with torch.no_grad():
        got = tmod(*_to(args, torch.from_numpy), **_to(kwargs, torch.from_numpy))
    ref, got = _flat(ref), _flat(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)


RESAMPLERS = {
    "nearest_up2": lambda m, x: m.nearest_up2(x),
    "avg_down2_odd_T": lambda m, x: m.avg_down2(x[:, :9]),
    "upfirdn1d_up2": lambda m, x: m.upfirdn1d(x, (0.5, 1.0, 0.25), up=2, pad=(2, 1)),
    "upfirdn1d_down2_cropped": lambda m, x: m.upfirdn1d(x, (1.0, 2.0, 3.0, 4.0), down=2, pad=(-1, 2)),
    "fir_up2": lambda m, x: m.fir_up2(x, gain=1.5),
    "fir_down2": lambda m, x: m.fir_down2(x),
    "k_down2": lambda m, x: m.k_down2(x),
    "k_up2": lambda m, x: m.k_up2(x),
}


@pytest.mark.parametrize("name", sorted(RESAMPLERS))
def test_resampler_matches_jax(name, rng):
    x = rng.standard_normal((2, 10, 3)).astype(np.float32)
    ref = np.asarray(RESAMPLERS[name](jbl, jnp.asarray(x)))
    got = RESAMPLERS[name](bl, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_factories_reject_unknown_names_as_jax():
    for factory, jfactory, args in ((bl.get_down_block, jbl.get_down_block, (1, 8, 8, E, True, 1e-5, "silu")),
                                    (bl.get_up_block, jbl.get_up_block, (1, 8, 8, 8, E, True, 1e-5, "silu"))):
        for f in (factory, jfactory):
            with pytest.raises(ValueError, match="does not exist"):
                f("NoSuchBlock2D", *args)
    for f in (bl.get_mid_block, jbl.get_mid_block):
        with pytest.raises(ValueError, match="unknown mid_block_type"):
            f("NoSuchMid", 8, E)
    assert bl.get_mid_block(None, 8, E) is None
