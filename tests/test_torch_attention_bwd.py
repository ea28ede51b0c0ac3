"""K4 backward: the port's plain version against the JAX Pallas backward, and
`FusedAttention` against autograd.

Inputs are made with numpy from a seed.  `fused_attention_bwd_plain` is held
to the JAX `_fused_bwd` (Pallas interpret mode, as tests/test_pallas.py runs
it) on the same (q, k, v, out, lse, dout) at atol 3e-5 / rtol 1e-4 in f32,
the JAX contract (tests/test_pallas.py:73-93): at its shapes and at the
diffusion trainer's (T, D) at H=8, B cut to 2, and at the block zoo's head
dim 8.  `FusedAttention` on the CPU
is held to torch.autograd through `ops/attention.py::dot_product_attention`
at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.ops.pallas.fused_attention import _fused_bwd, _fused_fwd
from latent_diffusion_speech_tpu_torch.ops import attention
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

# the trainer's K4 shapes (T, D) at H=8: the four UNet resolutions of a
# 1 s crop (86 frames padded to 88)
TRAIN_SHAPES = [(88, 32), (44, 48), (22, 64), (11, 64)]


def _arrays(rng, B, T, H, D, n=4):
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize(
    "B,T,H,D",
    [(2, 11, 4, 16), (2, 40, 4, 16)] + [(2, T, 8, D) for T, D in TRAIN_SHAPES]
    # head dim 8, the block zoo's attention heads (H = 32-64 at full width)
    + [(2, 44, 6, 8)],
)
def test_k4_bwd_plain_matches_pallas_kernel(rng, B, T, H, D):
    q, k, v, do = _arrays(rng, B, T, H, D)
    with pltpu.force_tpu_interpret_mode():
        out, res = _fused_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 16)
        ref = _fused_bwd(None, 16, res, jnp.asarray(do))
    lse = np.array(res[4])[:, :T]
    got = k4.fused_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, np.array(out), do, lse)))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("T,D", [(11, 16), (40, 32)])
def test_fused_attention_autograd_matches_dot_product_attention(rng, T, D):
    """f32 on the CPU: gradients through FusedAttention (plain forward and
    backward) equal autograd through the plain attention op."""
    q, k, v, co = (torch.from_numpy(a) for a in _arrays(rng, 2, T, 4, D))
    grads = []
    for fn in (k4.fused_attention, attention.dot_product_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        (out * co).sum().backward()
        grads.append([x.grad for x in leaves])
    for g, r, name in zip(*grads, "qkv"):
        torch.testing.assert_close(g, r, atol=3e-5, rtol=1e-4, msg=f"d{name}")


def test_fused_attention_builds_a_graph_only_when_a_gradient_is_needed(rng):
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(rng, 1, 12, 2, 32))
    assert k4.fused_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert k4.fused_attention(qg, k, v).grad_fn is None
    assert type(k4.fused_attention(qg, k, v).grad_fn).__name__ == "FusedAttentionBackward"


def test_k4_bwd_plain_rounds_p_and_ds_to_input_dtype(rng):
    """bf16: p and ds are rounded to bf16 before their products, f32
    accumulation, outputs in bf16 (the TPU backward's numerics)."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _arrays(rng, 1, 16, 2, 32))
    out, lse = k4.fused_attention_plain(q, k, v)
    dq, dk, dv = k4.fused_attention_bwd_plain(q, k, v, out, do, lse)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, do))
    scale = 32**-0.5
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse.reshape(1, 2, 16, 1))
    ref_dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof).bfloat16()
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta) * scale).bfloat16().float()
    torch.testing.assert_close(dv, ref_dv, atol=0, rtol=0)
    torch.testing.assert_close(dq, torch.einsum("bhqk,bkhd->bqhd", ds, kf).bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(dk, torch.einsum("bhqk,bqhd->bkhd", ds, qf).bfloat16(), atol=0, rtol=0)


def test_k4_bwd_wrapper_uses_plain_only_for_cpu(rng):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(rng, 1, 12, 2, 32))
    out, lse = k4.fused_attention_plain(q, k, v)
    before = k4.bwd_launches
    for g, r in zip(k4.attention_bwd(q, k, v, out, do, lse), k4.fused_attention_bwd_plain(q, k, v, out, do, lse)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert k4.bwd_launches == before  # the plain version is no launch
    meta = torch.empty((1, 12, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        k4.attention_bwd(meta, meta, meta, meta, meta, torch.empty((2, 12), device="meta"))
