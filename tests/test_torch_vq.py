"""The port's learned `VectorQuantize` against the JAX package's, on the CPU.

The state comes across with `convert.vq_state_from_jax`; inputs are numpy
draws from a seed.  Tolerance atol 1e-6 (f32 products of width 32 and 12)
on the quantized output, the commitment loss, the EMA state and the
straight-through gradient; the ids are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.quantize.codebook import VectorQuantize as JVectorQuantize
from latent_diffusion_speech_tpu_torch.convert import vq_state_from_jax
from latent_diffusion_speech_tpu_torch.quantize.codebook import VectorQuantize, VQState


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models: one intra-op thread (the parallel test run's workers
    would otherwise contend on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIM, K = 12, 64
ATOL = 1e-6


def _pair(seed=0, warm=True):
    jvq, vq = JVectorQuantize(DIM, K), VectorQuantize(DIM, K)
    jstate = jvq.init(jax.random.PRNGKey(seed))
    if warm:  # nonzero counts, as after a few steps
        jstate = jstate._replace(ema_counts=jnp.asarray(np.random.default_rng(seed).random(K).astype(np.float32)))
    return jvq, vq, jstate, vq_state_from_jax(jstate)


@pytest.mark.parametrize("train", [True, False])
def test_forward_ids_commitment_and_state_match_jax(rng, train):
    jvq, vq, jstate, state = _pair()
    x = rng.standard_normal((3, 40, DIM)).astype(np.float32)
    jout, jids, jcommit, jnew = jvq(jstate, jnp.asarray(x), train=train)
    out, ids, commit, new = vq(state, torch.from_numpy(x), train=train)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(commit.item(), float(jcommit), atol=ATOL, rtol=0)
    for name in VQState._fields:
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert (new is state) == (not train)
    np.testing.assert_array_equal(vq.encode(state, torch.from_numpy(x)).numpy(), np.asarray(jvq.encode(jstate, x)))
    np.testing.assert_allclose(vq.decode(state, ids).numpy(), np.asarray(jvq.decode(jstate, jids)), atol=ATOL)
    np.testing.assert_allclose(vq.utilization(new).item(), float(jvq.utilization(jnew)), atol=0)


def test_straight_through_gradient_matches_jax(rng):
    """d(sum(w * out) + commit)/dx: straight through the snap and through
    the commitment loss; the state takes no gradient."""
    jvq, vq, jstate, state = _pair(seed=1)
    x = rng.standard_normal((2, 30, DIM)).astype(np.float32)
    w = rng.standard_normal((2, 30, DIM)).astype(np.float32)

    def j_loss(xx):
        out, _, commit, _ = jvq(jstate, xx, train=True)
        return jnp.sum(out * w) + commit

    jgrad = jax.grad(j_loss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, _, commit, _ = vq(state, tx, train=True)
    ((out * torch.from_numpy(w)).sum() + commit).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=ATOL, rtol=0)
    assert not any(t.requires_grad for t in state)


def test_ties_go_to_the_lowest_id():
    _, vq, _, state = _pair()
    codebook = state.codebook.clone()
    codebook[5] = codebook[2]  # two equal codes: argmax takes the first
    state = state._replace(codebook=codebook)
    x = (codebook[2] @ torch.linalg.pinv(state.proj_in)).reshape(1, DIM)
    assert vq.encode(state, x).item() == 2


def test_init_draws_unit_codes_and_bounded_projections():
    vq = VectorQuantize(DIM, K)
    a, b = (vq.init(torch.Generator().manual_seed(s)) for s in (0, 0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_allclose(a.codebook.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert a.proj_in.abs().max() <= DIM ** -0.5 and a.proj_out.abs().max() <= 32 ** -0.5
    assert a.ema_counts.sum() == 0 and vq.utilization(a).item() == 0.0
