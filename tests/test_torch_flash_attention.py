"""K5 (`ops/kernels/flash_attention.py`) and the attention routes of the port
against the JAX package.

Inputs are made with numpy from a seed.  The K5 plain version is held to the
JAX Pallas kernel `flash_attention`, run in interpret mode as
tests/test_pallas.py runs it, at atol 2e-5 in f32 (the JAX contract),
including top-left causal attention with Tq != Tkv; in bf16 within 1e-2 of
max|out|, and closer to it than K4's rounding of p is.  Each
`dot_product_attention(impl=...)` route is held to the JAX function's at atol
2e-5.  The flagship UNet with attn_impl="pallas" is shown to call K5 and not
K4, and its attention layer in bf16 to follow the JAX layer's K5 numerics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.models.diffusion.unet1d import SelfAttention as JSelfAttention
from latent_diffusion_speech_tpu.ops.attention import dot_product_attention as j_attention
from latent_diffusion_speech_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from latent_diffusion_speech_tpu_torch.convert import _convert
from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.ops import attention
from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded


def _qkv(rng, B, Tq, Tkv, H, D):
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, H, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, H, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, Tq, Tkv, H, D, causal, block_q, block_k): tests/test_pallas.py's shapes
# at the JAX wrapper's default 128 x 128 blocks, its causal case, and causal
# cases with Tq != Tkv (top-left alignment) over several q and k blocks
KERNEL_CASES = [
    (2, 128, 128, 2, 64, False, 128, 128),
    (2, 100, 260, 2, 64, False, 128, 128),
    (1, 96, 96, 2, 32, True, 32, 32),
    (1, 40, 100, 2, 32, True, 16, 32),
    (2, 100, 40, 2, 48, True, 32, 16),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"B{c[0]}-Tq{c[1]}-Tkv{c[2]}-D{c[4]}-causal{c[5]}")
def test_plain_matches_pallas_kernel(rng, case):
    B, Tq, Tkv, H, D, causal, bq, bk = case
    q, k, v = _qkv(rng, B, Tq, Tkv, H, D)
    with pltpu.force_tpu_interpret_mode():
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal, block_q=bq, block_k=bk)
    got = k5.flash_attention(*_t(q, k, v), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_causal_is_top_left_not_bottom_right(rng):
    """Tq != Tkv: the kernel's rule (col <= row) is not the plain path's
    (tril(Tkv - Tq)); the two agree only when Tq == Tkv."""
    q, k, v = _t(*_qkv(rng, 1, 6, 10, 2, 8))
    got = k5.flash_attention_plain(q, k, v, is_causal=True)
    ref = attention.dot_product_attention(q[:, :1], k[:, :1], v[:, :1])  # row 0 sees key 0 only
    torch.testing.assert_close(got[:, :1], ref, atol=2e-6, rtol=0)
    assert (got - attention.dot_product_attention(q, k, v, is_causal=True)).abs().max() > 1e-2
    sq, sk, sv = (x[:, :6] for x in (q, k, v))
    torch.testing.assert_close(k5.flash_attention_plain(sq, sk, sv, is_causal=True),
                               attention.dot_product_attention(sq, sk, sv, is_causal=True), atol=2e-6, rtol=0)


@pytest.mark.parametrize("route", ["mask", "bias"])
def test_mask_and_bias_route_to_the_plain_attention(rng, route):
    q, k, v = _qkv(rng, 1, 16, 16, 2, 8)
    if route == "mask":
        extra = rng.random((1, 1, 16, 16)) < 0.7
        extra[..., 0] = True
    else:
        extra = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    ref = j_flash(*(jnp.asarray(a) for a in (q, k, v)), **{route: jnp.asarray(extra)})
    before = (k5.launches, k5.plain_routes)
    got = k5.flash_attention(*_t(q, k, v), **{route: torch.from_numpy(extra)})
    assert (k5.launches, k5.plain_routes) == (before[0], before[1] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_bf16_keeps_p_in_f32(rng):
    """bf16: within 1e-2 of max|out| of the JAX kernel (interpret mode), and
    closer to it than K4's numerics, which round p to bf16 before p @ v."""
    q, k, v = (2 * a for a in _qkv(rng, 2, 64, 64, 2, 32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))).astype(jnp.float32))
    qb, kb, vb = (x.bfloat16() for x in _t(q, k, v))
    got = k5.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= 1e-2 * np.abs(ref).max()
    err_k4 = np.abs(k4.fused_attention_plain(qb, kb, vb)[0].float().numpy() - ref)
    assert err.mean() < 0.1 * err_k4.mean()


# (Tq, Tkv, causal): self-attention, causal self-attention, cross lengths,
# and a T above the JAX 'fused' route's 512 cap (not for 'pallas': the
# kernel cases cover K5, and interpret mode at T=520 is slow)
ROUTE_CASES = [(24, 24, False), (24, 24, True), (12, 30, False), (520, 520, False)]
ROUTES = [(impl, case) for impl in ("xla", "pallas", "fused") for case in ROUTE_CASES
          if not (impl == "pallas" and case[0] > 512)]


@pytest.mark.parametrize("impl,case", ROUTES, ids=lambda c: c if isinstance(c, str) else "Tq{}-Tkv{}-causal{}".format(*c))
def test_dot_product_attention_routes_match_jax(rng, impl, case):
    Tq, Tkv, causal = case
    q, k, v = _qkv(rng, 1, Tq, Tkv, 2, 16)
    with pltpu.force_tpu_interpret_mode():
        ref = j_attention(*(jnp.asarray(a) for a in (q, k, v)), is_causal=causal, impl=impl)
    got = attention.dot_product_attention(*_t(q, k, v), is_causal=causal, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_fused_route_takes_k4_only_where_eligible(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "fused_attention", lambda *a: calls.append(a[0].shape) or k4.fused_attention(*a))
    for Tq, Tkv, causal in ROUTE_CASES:
        q, k, v = _t(*_qkv(rng, 1, Tq, Tkv, 2, 16))
        attention.dot_product_attention(q, k, v, is_causal=causal, impl="fused")
    assert calls == [(1, 24, 2, 16)]
    with pytest.raises(ValueError, match="impl"):
        attention.dot_product_attention(q, k, v, impl="cudnn")


def test_gradient_request_raises(rng):
    q, k, v = _t(*_qkv(rng, 1, 8, 8, 2, 8))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        k5.flash_attention(q, k, v)
    with torch.no_grad():
        torch.testing.assert_close(k5.flash_attention(q, k, v), k5.flash_attention_plain(q, k, v))
    meta = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        k5.flash_attention(meta, meta, meta)


FLAGSHIP = UNet1DConfig(in_channels=16, out_channels=6, block_out_channels=(16, 32), n_heads=2)


@pytest.mark.parametrize("attn_impl", ["pallas", "fused", "xla"])
def test_flagship_attn_impl_picks_the_kernel(rng, monkeypatch, attn_impl):
    """attn_impl='pallas' sends every self-attention of the flagship through
    the K5 wrapper and none through K4; 'fused' and 'xla' the reverse."""
    calls = {"k5": 0, "k4": 0}

    def spy(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(attention, "flash_attention", spy("k5", k5.flash_attention))
    monkeypatch.setattr(unet1d, "fused_attention", spy("k4", k4.fused_attention))
    cfg = dataclasses.replace(FLAGSHIP, attn_impl=attn_impl)
    model = seeded(lambda: UNet1D(cfg), 0)
    n_attn = sum(1 for name, _ in model.named_modules() if name.endswith(("attn1", "attn2")))
    with torch.no_grad():
        model(torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32)), torch.tensor([5]))
    assert n_attn > 0
    assert calls == ({"k5": n_attn, "k4": 0} if attn_impl == "pallas" else {"k5": 0, "k4": n_attn})


def test_flagship_attention_layer_bf16_follows_jax_k5(rng):
    """The flagship's attention layer with attn_impl='pallas' in bf16 against
    the JAX layer with attn_impl='pallas' (K5 in interpret mode) on the same
    weights: closer than the same layer with attn_impl='fused' (K4's
    rounding of p), which is the fault this route repairs."""
    x = rng.standard_normal((1, 64, 64)).astype(np.float32)
    jmod = JSelfAttention(64, 2, dtype=jnp.bfloat16, attn_impl="pallas")
    params = JSelfAttention(64, 2, attn_impl="xla").init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    state = _convert(jax.tree_util.tree_map(np.asarray, params))
    errs = {}
    for impl in ("pallas", "fused"):
        layer = unet1d.SelfAttention(64, 2, impl)
        layer.load_state_dict(state)
        layer = cast_compute_dtype(layer, torch.bfloat16)
        with torch.no_grad():
            got = layer(torch.from_numpy(x).bfloat16()).float().numpy()
        errs[impl] = np.abs(got - ref).mean()
    assert errs["pallas"] < 0.5 * errs["fused"], errs
