"""Sequence parallelism on torch.distributed: the port's ring attention,
the `sequence_parallel` routing, `encode_seq_parallel` and the LM trainer
under `seq`, against the JAX package and against a world of one.

Four gloo ranks of `tests/_torch_sp_pp_worker.py` (one launch for the
module, group `ring`; weights cross over through `convert.py`):
* at seq=4, each rank's chunk of the ring's output, and of dq, dk, dv,
  against JAX's `ring_attention` on an 8-device (data=2, seq=4) CPU mesh,
  causal and not, with a key-padding mask that pads whole chunks: JAX's
  tolerances, atol 2e-5 (gradients 3e-5);
* the routing inside `sequence_parallel`: eligible self-attention (no
  mask; a key-padding mask with causal) runs the ring once; a bias, the
  `fused` route and cross-attention of 32 queries on 64 keys (causal too,
  with its gradients) take the whole sequence's path; each output equals
  JAX's attention over the whole sequence; attention dropout raises;
* `encode_seq_parallel` of the RoFormer against JAX's, atol 3e-5;
* the LM trainer at data=2, seq=2: the RoFormer with hidden dropout 0.1,
  the dense Llama and the Llama with experts whose capacity overflows,
  three steps each, equal to a world of one fed the same global batches
  (JAX's `test_lm_trainer_sp_matches_dp` bounds: losses rtol 2e-5,
  parameters rtol 5e-4, atol 1e-5; Adam's step bound where the world of
  one's gradient sat at rounding level, as the tensor-parallel check).
In this process: `_ring_eligible` decides as JAX's does, the ring without
a group is plain attention, and JAX's ValueErrors (attention dropout under
`seq`, a token length the axis does not divide).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from latent_diffusion_speech_tpu.config import ParallelConfig as JParallelConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.ops import attention as jattention
from latent_diffusion_speech_tpu.ops.ring_attention import ring_attention as j_ring
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh as j_build_mesh
from latent_diffusion_speech_tpu_torch.convert import roformer_from_jax
from latent_diffusion_speech_tpu_torch.ops import attention as tattention
from latent_diffusion_speech_tpu_torch.ops.ring_attention import ring_attention
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
from tests import _torch_sp_pp_worker as W

N = 4  # the seq axis of the ring cases


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_encoder() -> JRoformerSystem:
    e, d = W.ENC_ROFORMER.encoder, W.ENC_ROFORMER.decoder
    cfg = JRoformerConfig(
        encoder=JStackConfig(num_hidden_layers=e.num_hidden_layers, hidden_size=e.hidden_size,
                             num_attention_heads=e.num_attention_heads, intermediate_size=e.intermediate_size),
        decoder=JStackConfig(num_hidden_layers=d.num_hidden_layers, hidden_size=d.hidden_size,
                             num_attention_heads=d.num_attention_heads, intermediate_size=d.intermediate_size),
        semantic_kmeans_num=W.ENC_ROFORMER.semantic_kmeans_num, n_spk=W.ENC_ROFORMER.n_spk)
    return JRoformerSystem(cfg, seed=0)


def _jax_references(jmesh, jenc) -> dict:
    """Every JAX result the tests hold the ranks to."""
    ref = {}
    spec = NamedSharding(jmesh, P(None, "seq", None, None))
    for case in ("plain", "mask"):
        a = W.ring_inputs(case)
        for causal in (False, True):
            args = [jax.device_put(a[x], spec) for x in "qkv"]
            kw = {}
            if "kv_mask" in a:
                kw["kv_mask"] = jax.device_put(a["kv_mask"], NamedSharding(jmesh, P(None, "seq")))
            ref[(case, causal)] = np.asarray(jax.jit(
                lambda q, k, v, m=None, c=causal: j_ring(q, k, v, jmesh, is_causal=c, kv_mask=m))(*args, *kw.values()))
    a = {k: jnp.asarray(v) for k, v in W.ring_inputs("grad").items()}
    for causal in (False, True):
        def loss(q, k, v, c=causal):
            return jnp.sum(j_ring(q, k, v, jmesh, is_causal=c) * a["w"])

        ref[("grad", causal)] = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            a["q"], a["k"], a["v"])]
    a = {k: jnp.asarray(v) for k, v in W.ring_inputs("grad_mask").items()}
    ref[("grad_mask", True)] = np.asarray(jax.jit(jax.grad(
        lambda q: jnp.sum(j_ring(q, q, q, jmesh, is_causal=True, kv_mask=a["kv_mask"]) ** 2)))(a["q"]))
    r = {k: jnp.asarray(v) for k, v in W.routing_inputs().items()}
    x, m = r["x"], r["kv_mask"][:, None, None, :]
    ref["routing"] = {
        "self": jattention.dot_product_attention(x, x, x),
        "self_causal_mask": jattention.dot_product_attention(x, x, x, mask=m[..., :32], is_causal=True),
        "bias": jattention.dot_product_attention(x, x, x, bias=r["bias"]),
        "fused": jattention.dot_product_attention(x, x, x, impl="fused"),
        "cross": jattention.dot_product_attention(r["q"], r["k"], r["v"], mask=m),
        "cross_causal": jattention.dot_product_attention(r["q"], r["k"], r["v"], mask=m, is_causal=True),
    }
    for case in ("cross", "cross_causal"):
        ref["routing"][case + "_grads"] = jax.grad(
            lambda q, k, v, c=case: jnp.sum(jattention.dot_product_attention(q, k, v, mask=m,
                                                                               is_causal=c == "cross_causal")),
            argnums=(0, 1, 2))(r["q"], r["k"], r["v"])
    e = W.enc_inputs()
    ref["encode"] = np.asarray(jenc.encode_seq_parallel(e["phone"].astype(np.int32), e["tone"].astype(np.int32),
                                                        e["spk"].astype(np.int32), mesh=jmesh))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(out dir, the four ranks' results, JAX's references): the ranks
    run while this process computes the references."""
    out = tmp_path_factory.mktemp("ring")
    jenc = _jax_encoder()
    torch.save(roformer_from_jax(jenc.params), out / "enc_roformer.pt")
    procs = W.start(out, "ring")
    try:
        ref = _jax_references(j_build_mesh(JParallelConfig(data=2, seq=4)), jenc)
    finally:
        ranks = W.finish(procs, out, "ring")
    return out, ranks, ref


def _whole(ranks, get) -> np.ndarray:
    """The ranks' chunks in seq order, joined along the token dimension."""
    by_c = {r["coords"][1]: get(r) for r in ranks}
    return torch.cat([by_c[c] for c in range(N)], dim=1).detach().numpy()


# -- the ring ------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", ["plain", "mask"])
def test_ring_matches_jax(run, case, causal):
    """Causal or not; `mask` pads rows to 64, 40 and 9 keys (three of the
    four chunks of the last row wholly masked: its all-masked guard)."""
    _, ranks, ref = run
    got = _whole(ranks, lambda r: r["ring"][(case, causal)]["out"])
    np.testing.assert_allclose(got, ref[(case, causal)], atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(run, causal):
    _, ranks, ref = run
    for i, name in enumerate(("dq", "dk", "dv")):
        got = _whole(ranks, lambda r: r["ring"][("grad", causal)][name])
        np.testing.assert_allclose(got, ref[("grad", causal)][i], atol=3e-5)


def test_ring_gradients_with_kv_mask_match_jax(run):
    _, ranks, ref = run
    got = _whole(ranks, lambda r: r["ring"][("grad_mask", True)]["dq"])
    np.testing.assert_allclose(got, ref[("grad_mask", True)], atol=3e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_without_a_group_is_plain_attention(causal):
    """A world of one (no group): one local block, JAX's plain attention."""
    a = W.ring_inputs("mask")
    q, k, v = (torch.as_tensor(a[x]) for x in "qkv")
    got = ring_attention(q, k, v, None, is_causal=causal, kv_mask=torch.as_tensor(a["kv_mask"]))
    want = jattention.dot_product_attention(*(jnp.asarray(a[x]) for x in "qkv"), is_causal=causal,
                                            mask=jnp.asarray(a["kv_mask"])[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- the routing ---------------------------------------------------------------------------------------------

@pytest.mark.parametrize("case", W.ROUTING)
def test_sequence_parallel_routing(run, case):
    """Eligible self-attention takes the ring (one call), every other call
    the whole sequence's path; each output is JAX's over the whole sequence,
    and cross-attention's gradients JAX's too."""
    _, ranks, ref = run
    got = _whole(ranks, lambda r: r["routing"][case]["out"])
    np.testing.assert_allclose(got, np.asarray(ref["routing"][case]), atol=2e-5)
    assert all(r["routing"][case]["ring"] == (1 if case.startswith("self") else 0) for r in ranks)
    if case.startswith("cross"):
        for i, name in enumerate(("dq", "dk", "dv")):
            g = _whole(ranks, lambda r: r["routing"][case + "_grads"][name])
            np.testing.assert_allclose(g, np.asarray(ref["routing"][case + "_grads"][i]), atol=2e-5)


def test_attention_dropout_inside_the_context_raises(run):
    _, ranks, _ = run
    assert all(r["routing"]["dropout_raises"] for r in ranks)


ELIGIBILITY = [("none", None), ("key_padding", "kp"), ("full_mask", "full"), ("mask_2d", "2d"), ("bias", "bias"),
               ("dropout", "drop"), ("cross", "cross")]


@pytest.mark.parametrize("name,kind", ELIGIBILITY, ids=[e[0] for e in ELIGIBILITY])
def test_ring_eligibility_matches_jax(name, kind):
    """`_ring_eligible` on a rank's chunks decides as JAX's on the whole:
    no bias, no dropout, one length, at most a (B, 1, 1, T) key mask."""
    T = 32
    jmesh = j_build_mesh(JParallelConfig(data=2, seq=N))
    mesh = Mesh(MeshSpec(data=1, seq=N, model=1))

    def args(t, tk, np_mod):
        q = np_mod.zeros((1, t, 2, 8), np_mod.float32)
        k = np_mod.zeros((1, tk, 2, 8), np_mod.float32)
        mask = {"kp": np_mod.ones((1, 1, 1, tk), bool), "full": np_mod.ones((1, 1, t, tk), bool),
                "2d": np_mod.ones((t, tk), bool)}.get(kind)
        bias = np_mod.zeros((1, 2, t, tk), np_mod.float32) if kind == "bias" else None
        return q, k, bias, mask

    tk = T * 2 if kind == "cross" else T
    rate = 0.1 if kind == "drop" else 0.0
    with jattention.sequence_parallel(jmesh):
        q, k, bias, mask = args(T, tk, jnp)
        want = jattention._ring_eligible(q, k, bias, mask, rate, jax.random.PRNGKey(0)) is not None
    with tattention.sequence_parallel(mesh):
        q, k, bias, mask = (torch.as_tensor(np.asarray(a)) if a is not None else None for a in args(T // N, tk // N, np))
        got = tattention._ring_eligible(q, k, bias, mask, rate, torch.Generator()) is not None
    assert got == want == (kind in (None, "kp"))


# -- the encoder ---------------------------------------------------------------------------------------------

def test_encode_seq_parallel_matches_jax(run):
    _, ranks, ref = run
    got = _whole(ranks, lambda r: r["encode"])
    np.testing.assert_allclose(got, ref["encode"], atol=3e-5)


# -- the trainer ---------------------------------------------------------------------------------------------

@pytest.mark.parametrize("case", W.SEQ_LAYOUTS["dp_sp"][1])
def test_lm_trainer_seq_equals_world_of_one(run, case, tmp_path):
    """data=2, seq=2 against a world of one on the same global batches:
    the RoFormer's hidden dropout drawn whole and cut, the experts routed
    over the global token order (their capacity overflows: the dropped
    shares equal too)."""
    _, ranks, _ = run
    one = W.run_trainer(tmp_path / "one", case, {})
    for r in ranks:
        got = r[f"dp_sp/{case}"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-5)
        assert got["losses"] == ranks[0][f"dp_sp/{case}"]["losses"]
        W.check_params(got, one)
        np.testing.assert_allclose(got["drops"], one["drops"], atol=1e-6)
    if case == "llama_moe":
        assert min(min(d) for d in one["drops"]) > 0  # the capacity overflows
    assert sorted({r["dp_sp/" + case]["coords"][:2] for r in ranks}) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_seq_requires_no_attention_dropout(tmp_path):
    """JAX's ValueError when the RoFormer's attention dropout is on."""
    cfg, model = W.lm_cfg(tmp_path, "roformer", {})
    cfg.parallel.seq = 2
    model = dataclasses.replace(model, encoder=dataclasses.replace(model.encoder, attention_probs_dropout_prob=0.1))
    with pytest.raises(ValueError, match="attention_probs_dropout"):
        LMTrainer(cfg, lm_cfg=model, device="cpu", mesh=Mesh(MeshSpec(data=1, seq=2, model=1)))


def test_seq_token_length_must_divide(tmp_path):
    """JAX's ValueError for a token length `seq` does not divide."""
    cfg, model = W.lm_cfg(tmp_path, "llama", {})
    t = LMTrainer(cfg, lm_cfg=model, device="cpu", mesh=Mesh(MeshSpec(data=1, seq=2, model=1)))
    ids = np.zeros((2, 15), np.int64)
    with pytest.raises(ValueError, match=r"^seq-parallel: batch dim input_ids=15 not divisible by seq=2"):
        t.train_step(t.device_put_batch({"input_ids": ids, "labels": ids}))
