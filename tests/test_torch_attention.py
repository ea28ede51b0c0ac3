"""The port's attention ops and the K4 plain version against the JAX package.

Inputs are made with numpy from a seed and run in f32 on the CPU.  The plain
attention and rotary are held at atol 2e-5 to `ops/attention.py`; the K4
plain version at atol 2e-5 (out and LSE) to the JAX Pallas kernel
`fused_attention`, run in interpret mode as tests/test_pallas.py runs it,
including a T above the JAX wrapper's 512 cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.ops.attention import apply_rotary as j_apply_rotary
from latent_diffusion_speech_tpu.ops.attention import dot_product_attention as j_attention
from latent_diffusion_speech_tpu.ops.attention import rotate_half as j_rotate_half
from latent_diffusion_speech_tpu.ops.pallas.fused_attention import _fused_fwd
from latent_diffusion_speech_tpu_torch.ops import attention
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4


def _qkv(rng, B, Tq, Tkv, H, D):
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, H, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, H, D)).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "mask", "causal", "bias", "cross_causal"])
def test_dot_product_attention_matches(rng, case):
    Tq, Tkv = (5, 9) if case == "cross_causal" else (9, 9)
    q, k, v = _qkv(rng, 2, Tq, Tkv, 3, 8)
    kw_j, kw_t = {}, {}
    if case == "mask":
        m = rng.random((2, 1, 1, Tkv)) < 0.7
        m[..., 0] = True
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if case in ("causal", "cross_causal"):
        kw_j["is_causal"] = kw_t["is_causal"] = True
    if case == "bias":
        b = rng.standard_normal((2, 3, Tq, Tkv)).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(b), torch.from_numpy(b)
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
    got = attention.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_rotary_matches(rng):
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    sin = np.repeat(rng.standard_normal((7, 4)), 2, axis=-1).astype(np.float32)
    cos = np.repeat(rng.standard_normal((7, 4)), 2, axis=-1).astype(np.float32)
    np.testing.assert_allclose(attention.rotate_half(torch.from_numpy(x)).numpy(),
                               np.asarray(j_rotate_half(jnp.asarray(x))), atol=2e-5)
    ref = j_apply_rotary(jnp.asarray(x), jnp.asarray(sin[:, None]), jnp.asarray(cos[:, None]))
    got = attention.apply_rotary(torch.from_numpy(x), torch.from_numpy(sin[:, None]),
                                 torch.from_numpy(cos[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("t", [11, 88, 520])
def test_k4_plain_matches_pallas_kernel(rng, t):
    q, k, v = _qkv(rng, 1, t, t, 2, 32)
    with pltpu.force_tpu_interpret_mode():
        ref, res = _fused_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 16)
    ref_lse = np.asarray(res[4])[:, :t]
    out, lse = k4.fused_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5)


def test_k4_plain_rounds_p_to_input_dtype(rng):
    """bf16 inputs: p is rounded to bf16 before p @ v, as in the TPU kernel."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 1, 16, 16, 2, 32))
    out, _ = k4.fused_attention_plain(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 32**-0.5
    p = torch.softmax(s, -1).bfloat16().float()
    ref = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_k4_wrapper_uses_plain_only_for_cpu(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 12, 12, 2, 32))
    torch.testing.assert_close(k4.fused_attention(q, k, v), k4.fused_attention_plain(q, k, v)[0])
    meta = torch.empty((1, 12, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        k4.fused_attention(meta, meta, meta)
