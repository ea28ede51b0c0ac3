"""Pipeline parallelism on torch.distributed: the port's `pipeline_apply`,
both LMs' `loss_pp`, the LM trainer over `pipe` and its compositions, and
`dcn_data`'s layout, against the JAX package and against a world of one.

Four gloo ranks of `tests/_torch_sp_pp_worker.py` (one launch for the
module, group `pp`; weights cross over through `convert.py`):
* `pipeline_apply` at pipe=4 against JAX's on an 8-device (data=2, pipe=4)
  CPU mesh: the sequential composition, a pytree activation with a bool
  leaf, the gradients of the stacked stage weights and of the input, and
  the same under `remat`; at data=2, pipe=2 each rank's rows of every
  microbatch (passed by the rank) against JAX's (data=4, pipe=2) mesh with
  `batch_axis="data"`: rtol 1e-5, atol 1e-6;
* both LMs' `loss_pp` and gradients (summed over the pipe ranks) against
  JAX's `loss_pp`: the Llama with 4 blocks over 4 stages, the RoFormer's 3
  encoder and 2 decoder layers in 4 stages of 2 slots (3 identity slots);
  the Llama with 4 experts at data=2, pipe=2 against JAX's (data=2,
  pipe=2, expert=2) mesh with `batch_axis="data"`, its capacity
  overflowing inside each microbatch (the routing statistics ride the
  activation; the ranks' losses averaged over `data`): values rtol 2e-5,
  gradients rtol 5e-4, atol 1e-5; the same under `remat`, equal to it
  (the recompute routes over `data` as the forward did);
* the LM trainer at data=2 x pipe=2 (the Llama with 4 blocks and the
  RoFormer), model=2 x pipe=2, pipe=2 x expert=2 and dcn_data=2, three
  steps each, equal to a world of one fed the same global batches (JAX's
  `test_lm_trainer_pp_matches_dp` bounds; Adam's step bound where the world
  of one's gradient sat at rounding level).
In this process: `pipeline_apply` over one stage (its `remat` recompute
re-entering the forward's contexts), `loss_pp` against `loss`
at a world of one, JAX's ValueErrors, and `dcn_data`'s rank coordinates
against JAX's `create_hybrid_device_mesh`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.config import ParallelConfig as JParallelConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaSystem as JLlamaSystem
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh as j_build_mesh
from latent_diffusion_speech_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from latent_diffusion_speech_tpu_torch.config import ParallelConfig
from latent_diffusion_speech_tpu_torch.convert import llama_from_jax, roformer_from_jax
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.ops import attention
from latent_diffusion_speech_tpu_torch.ops.attention import sequence_parallel
from latent_diffusion_speech_tpu_torch.ops.moe import MoEMLP, data_parallel
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec, rank_coords, resolve
from latent_diffusion_speech_tpu_torch.parallel.pipeline import bubble_fraction, pipeline_apply
from tests import _torch_sp_pp_worker as W


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_stack(s: StackConfig) -> JStackConfig:
    return JStackConfig(num_hidden_layers=s.num_hidden_layers, hidden_size=s.hidden_size,
                        num_attention_heads=s.num_attention_heads, intermediate_size=s.intermediate_size)


def _jax_systems() -> dict:
    moe_mesh = j_build_mesh(JParallelConfig(data=2, pipe=2, expert=2))
    r = W.PP_ROFORMER
    return {"llama": JLlamaSystem(JLlamaConfig(**W.PP_LLAMA), seed=0),
            "roformer": JRoformerSystem(JRoformerConfig(encoder=_j_stack(r.encoder), decoder=_j_stack(r.decoder),
                                                        semantic_kmeans_num=r.semantic_kmeans_num, n_spk=r.n_spk),
                                        seed=0),
            "moe": JLlamaSystem(JLlamaConfig(**W.MOE_LLAMA), seed=0, mesh=moe_mesh), "moe_mesh": moe_mesh}


def _j_stage_tanh(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _jax_references(js: dict) -> dict:
    mesh = j_build_mesh(JParallelConfig(data=2, pipe=4))
    ref = {}
    a = W.pipe_inputs("sequential")
    ref["sequential"] = np.asarray(j_pipeline_apply(mesh, _j_stage_tanh, {"w": a["w"], "b": a["b"]}, a["x"]))
    a = W.pipe_inputs("pytree")
    h, g = j_pipeline_apply(mesh, lambda p, act: (jnp.where(act[1], jnp.tanh(act[0] @ p["w"]), act[0]), act[1]),
                            {"w": a["w"]}, (a["x"], a["gate"]))
    ref["pytree"] = (np.asarray(h), np.asarray(g))
    a = W.pipe_inputs("grads")
    for remat in (False, True):
        def loss(w, b, x, r=remat):
            return jnp.sum(j_pipeline_apply(mesh, _j_stage_tanh, {"w": w, "b": b}, x, remat=r) ** 2)

        ref["remat" if remat else "grads"] = [np.asarray(t) for t in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            a["w"], a["b"], a["x"])]
    a = W.pipe_inputs("batch_axis")
    ref["batch_axis"] = np.asarray(j_pipeline_apply(j_build_mesh(JParallelConfig(data=4, pipe=2)), _j_stage_tanh,
                                                    {"w": a["w"], "b": a["b"]}, a["x"], batch_axis="data"))
    b = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v) for k, v in W.pp_inputs("llama").items()}
    ref["loss_pp/llama"] = jax.jit(jax.value_and_grad(lambda p: js["llama"].loss_pp(
        p, b["input_ids"], b["labels"], mesh, attention_mask=b["attention_mask"],
        microbatches=W.PP_M["llama"])))(js["llama"].params)
    b = {k: jnp.asarray(v.astype(np.int32)) for k, v in W.pp_inputs("roformer").items()}
    ref["loss_pp/roformer"] = jax.jit(jax.value_and_grad(lambda p: js["roformer"].loss_pp(
        p, b["phone"], b["tone"], b["semantic"], b["labels"], mesh, spk_id=b["spk_id"],
        encoder_attention_mask=b["encoder_attention_mask"], attention_mask=b["attention_mask"],
        microbatches=W.PP_M["roformer"])))(js["roformer"].params)
    b = {k: jnp.asarray(v.astype(np.int32)) for k, v in W.pp_inputs("moe").items()}
    ref["loss_pp/moe"] = jax.jit(jax.value_and_grad(lambda p: js["moe"].loss_pp(
        p, b["input_ids"], b["labels"], js["moe_mesh"], microbatches=W.PP_M["moe"], batch_axis="data")))(
        js["moe"].params)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(out dir, the four ranks' results, JAX's references): the ranks
    run while this process computes the references."""
    out = tmp_path_factory.mktemp("pp")
    js = _jax_systems()
    torch.save(llama_from_jax(js["llama"].params), out / "pp_llama.pt")
    torch.save(roformer_from_jax(js["roformer"].params), out / "pp_roformer.pt")
    torch.save(llama_from_jax(js["moe"].params), out / "pp_moe.pt")
    procs = W.start(out, "pp")
    try:
        ref = _jax_references(js)
    finally:
        ranks = W.finish(procs, out, "pp")
    return out, ranks, ref


# -- pipeline_apply ------------------------------------------------------------------------------------------

def test_pipeline_apply_matches_jax_sequential(run):
    """Four stages of tanh(h w + b) over six microbatches: every rank
    holds JAX's result."""
    _, ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["pipe"]["sequential"].numpy(), ref["sequential"], rtol=1e-5, atol=1e-6)


def test_pytree_activation_rides_along(run):
    _, ranks, ref = run
    for r in ranks:
        h, g = r["pipe"]["pytree"]
        np.testing.assert_allclose(h.numpy(), ref["pytree"][0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g.numpy(), ref["pytree"][1])


@pytest.mark.parametrize("case", ["grads", "remat"])
def test_pipeline_gradients_match_jax(run, case):
    """Each rank's gradient of the stacked weights is its stage's slice
    (zero elsewhere) and the input's lands on stage 0: summed over the
    ranks they are JAX's."""
    _, ranks, ref = run
    for i, name in enumerate(("w", "b", "x")):
        got = sum(r["pipe"][case][name] for r in ranks)
        np.testing.assert_allclose(got.numpy(), ref[case][i], rtol=1e-5, atol=1e-6)
    for r in ranks:
        s = r["coords"][3]
        rest = torch.ones(4, dtype=torch.bool)
        rest[s] = False
        assert not r["pipe"][case]["w"][rest].any() and r["pipe"][case]["w"][s].any()
        assert r["pipe"][case]["x"].any() == (s == 0)


def test_batch_axis_rows_match_jax(run):
    """data=2, pipe=2: each data coordinate's rows of every microbatch."""
    _, ranks, ref = run
    for r in ranks:
        d = r["dp_coords"][0]
        np.testing.assert_allclose(r["batch_axis"].numpy(), ref["batch_axis"][:, d * 2:(d + 1) * 2], rtol=1e-5,
                                   atol=1e-6)


def test_single_stage_runs_the_stages_in_turn():
    """pipe=1 (a world of one): each microbatch through the stages in
    turn, JAX's degenerate mesh's result (with and without remat)."""
    a = W.pipe_inputs("single")
    want = np.asarray(j_pipeline_apply(j_build_mesh(JParallelConfig(data=8)), _j_stage_tanh,
                                       {"w": a["w"], "b": a["b"]}, a["x"]))
    for remat in (False, True):
        w = torch.as_tensor(a["w"]).requires_grad_()
        got = pipeline_apply(Mesh(MeshSpec(data=1, seq=1, model=1)), W.stage_tanh,
                             {"w": w, "b": torch.as_tensor(a["b"])}, torch.as_tensor(a["x"]), remat=remat)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
        got.sum().backward()
        assert w.grad.abs().sum() > 0
    assert bubble_fraction(4, 4) == 3 / 7 and bubble_fraction(1, 4) == 0


def test_single_stage_remat_reenters_the_forward_contexts():
    """The backward's recompute runs after the caller's contexts have
    closed: it sees the forward's sequence-parallel stack and MoE mesh,
    and leaves the layer's mesh and statistics as it found them."""
    mesh = Mesh(MeshSpec(data=1, seq=1, model=1))
    layer = MoEMLP(8, 2, 16)
    seen = []

    def stage(p, h):
        seen.append((list(attention._seq_parallel), layer.mesh))
        layer.stats = h.sum()
        return torch.tanh(h @ p[1])

    stages = [[layer, torch.randn(8, 8, requires_grad=True)] for _ in range(2)]
    with data_parallel(layer, mesh), sequence_parallel(mesh):
        out = pipeline_apply(mesh, stage, stages, torch.randn(3, 2, 8), remat=True)
        stats = layer.stats
    out.sum().backward()
    assert len(seen) == 12 and all(s == ([(mesh, "seq")], mesh) for s in seen)
    assert layer.mesh is None and layer.stats is stats and attention._seq_parallel == []
    assert all(p[1].grad.abs().sum() > 0 for p in stages)


# -- loss_pp -------------------------------------------------------------------------------------------------

def _port_grads(ranks, case: str, data_axis: bool) -> dict:
    """The gradients summed over the pipe ranks (each counted once there),
    averaged over the data axis."""
    out = {}
    for name in ranks[0][f"loss_pp/{case}"][1]:
        g = sum(r[f"loss_pp/{case}"][1][name] for r in ranks)
        out[name] = g / 2 if data_axis else g
    return out


@pytest.mark.parametrize("case", ["llama", "roformer", "moe"])
def test_loss_pp_matches_jax(run, case):
    _, ranks, ref = run
    value, jgrads = ref[f"loss_pp/{case}"]
    data_axis = case == "moe"
    if data_axis:  # the ranks' shares averaged over data; the same on both pipe ranks
        by_d = {}
        for r in ranks:
            by_d.setdefault(r["dp_coords"][0], set()).add(r[f"loss_pp/{case}"][0])
        assert all(len(v) == 1 for v in by_d.values())
        got = np.mean([v.pop() for v in by_d.values()])
        assert min(min(r["loss_pp/moe"][2]) for r in ranks) > 0  # the capacity overflowed
    else:
        got = ranks[0][f"loss_pp/{case}"][0]
        assert all(r[f"loss_pp/{case}"][0] == got for r in ranks)
    np.testing.assert_allclose(got, float(value), rtol=2e-5)
    want = (roformer_from_jax if case == "roformer" else llama_from_jax)(jax.tree_util.tree_map(np.asarray, jgrads))
    mine = _port_grads(ranks, case, data_axis)
    assert sorted(mine) == sorted(want)
    for name, g in mine.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=5e-4, atol=1e-5, err_msg=name)


def test_loss_pp_remat_routes_as_its_forward(run):
    """data=2, pipe=2, the experts' capacity overflowing: with `remat` each
    stage is recomputed in the backward, routed over `data` as its forward
    was, so the loss, the gradients and the drop fractions are those
    without it."""
    _, ranks, _ = run
    for r in ranks:
        loss, grads, drops = r["loss_pp/moe"]
        loss_r, grads_r, drops_r = r["loss_pp/moe_remat"]
        assert loss_r == loss and drops_r == drops and min(drops) > 0
        for name, g in grads.items():
            np.testing.assert_allclose(grads_r[name].numpy(), g.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", ["llama", "llama_moe", "roformer"])
def test_loss_pp_equals_loss_at_a_world_of_one(case):
    """pipe=1: each microbatch through every layer, the same value and
    gradients as `loss` (no capacity overflow: factor 4)."""
    if case == "roformer":
        lm = RoformerSystem(W.PP_ROFORMER, device="cpu", training=True)
        b = {k: torch.as_tensor(v) for k, v in W.pp_inputs("roformer").items()}
        base = lm.loss(b)
        pp = lm.loss_pp(b["phone"], b["tone"], b["semantic"], b["labels"], None, spk_id=b["spk_id"],
                        encoder_attention_mask=b["encoder_attention_mask"], attention_mask=b["attention_mask"])
    else:
        kw = W.PP_LLAMA if case == "llama" else {**W.MOE_LLAMA, "moe_capacity_factor": 4.0}
        lm = LlamaSystem(LlamaConfig(**kw), device="cpu", training=True)
        b = {k: torch.as_tensor(v) for k, v in W.pp_inputs("llama" if case == "llama" else "moe").items()}
        base = lm.loss(b)
        pp = lm.loss_pp(b["input_ids"], b["labels"], Mesh(MeshSpec(data=1, seq=1, model=1)),
                        attention_mask=b.get("attention_mask"), microbatches=2)
    params = list(lm.module.parameters())
    g_base = torch.autograd.grad(base, params, allow_unused=True)
    g_pp = torch.autograd.grad(pp, params, allow_unused=True)
    np.testing.assert_allclose(pp.item(), base.item(), rtol=2e-5)
    for a, b_ in zip(g_pp, g_base):
        if b_ is not None:
            np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=5e-4, atol=1e-5)


def test_roformer_geometry_raises_jax_error():
    """Stacks of two widths cannot share a slot layout: JAX's message."""
    cfg = RoformerConfig(encoder=StackConfig(num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
                                             intermediate_size=48),
                         decoder=StackConfig(num_hidden_layers=1, hidden_size=64, num_attention_heads=2,
                                             intermediate_size=48), semantic_kmeans_num=16, n_spk=2)
    jcfg = JRoformerConfig(encoder=_j_stack(cfg.encoder), decoder=_j_stack(cfg.decoder), semantic_kmeans_num=16,
                           n_spk=2)
    phone = np.ones((4, 8), np.int32)
    with pytest.raises(ValueError) as jerr:
        JRoformerSystem(jcfg, seed=0).loss_pp(None, phone, phone, phone, phone, j_build_mesh(JParallelConfig(
            data=2, pipe=4)))
    t = torch.ones((4, 8), dtype=torch.long)
    with pytest.raises(ValueError) as err:
        RoformerSystem(cfg, device="cpu").loss_pp(t, t, t, t, Mesh(MeshSpec(data=1, seq=1, model=1, pipe=4)))
    assert str(err.value) == str(jerr.value) and "hidden" in str(err.value)


def test_llama_layers_and_microbatches_raise_jax_errors():
    lm = LlamaSystem(LlamaConfig(**{**W.PP_LLAMA, "num_hidden_layers": 3}), device="cpu")
    ids = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(ValueError, match=r"^loss_pp: 3 layers not divisible by pipe=2$"):
        lm.loss_pp(ids, ids, Mesh(MeshSpec(data=1, seq=1, model=1, pipe=2)))
    with pytest.raises(ValueError, match=r"^loss_pp: batch 4 not divisible by microbatches 3$"):
        lm.loss_pp(ids, ids, None, microbatches=3)


# -- the trainer ---------------------------------------------------------------------------------------------

TRAINER = [(layout, case) for layout, (_, cases) in W.PP_LAYOUTS.items() for case in cases]


@pytest.mark.parametrize("layout,case", TRAINER, ids=[f"{a}-{b}" for a, b in TRAINER])
def test_lm_trainer_pipe_equals_world_of_one(run, layout, case, tmp_path):
    """Three steps against a world of one on the same global batches; the
    ranks report the same losses; split parameters are held chunk by
    chunk."""
    _, ranks, _ = run
    one = W.run_trainer(tmp_path / "one", case, {})
    for r in ranks:
        got = r[f"{layout}/{case}"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-5)
        assert got["losses"] == ranks[0][f"{layout}/{case}"]["losses"]
        mesh = Mesh(MeshSpec(**{k: got["spec"][k] for k in ("data", "seq", "model", "pipe", "expert")}),
                    coords=got["coords"])
        W.check_params(got, one, mesh)
    want = {"data": 4} if layout == "dcn" else W.PP_LAYOUTS[layout][0]  # dcn: two slices of data=2
    assert all(ranks[0][f"{layout}/{case}"]["spec"][k] == v for k, v in want.items())


# -- dcn_data ------------------------------------------------------------------------------------------------

DCN = [(4, dict(dcn_data=2)), (8, dict(dcn_data=2, model=2)), (8, dict(dcn_data=4)),
       (8, dict(dcn_data=2, pipe=2)), (8, dict(dcn_data=2, seq=2, expert=2))]


@pytest.mark.parametrize("n,kw", DCN, ids=[f"{n}-{kw}" for n, kw in DCN])
def test_dcn_data_coordinates_match_jax_layout(n, kw):
    """JAX's `create_hybrid_device_mesh` (mesh.py:87-96) over devices whose
    slice is their rank // (n / dcn_data), torchrun's node-major ranks:
    each rank sits at the port's coordinate, the DCN factor outermost on
    `data`."""
    from jax.experimental import mesh_utils

    from latent_diffusion_speech_tpu.parallel.mesh import _resolve_spec as j_resolve_spec

    class Dev:
        platform = device_kind = "cpu"

        def __init__(self, i, per):
            self.id, self.slice_index, self.process_index = i, i // per, i

    dcn = kw["dcn_data"]
    inner = j_resolve_spec(JParallelConfig(**kw), n // dcn)
    devs = mesh_utils.create_hybrid_device_mesh(
        (inner.data, inner.seq, inner.model, inner.pipe, inner.expert), (dcn, 1, 1, 1, 1),
        devices=[Dev(i, n // dcn) for i in range(n)])
    spec = resolve(ParallelConfig(**kw), n)
    assert devs.shape == (spec.data, spec.seq, spec.model, spec.pipe, spec.expert)
    for idx in np.ndindex(devs.shape):
        assert rank_coords(devs[idx].id, spec) == idx


def test_dcn_data_that_does_not_divide_raises():
    with pytest.raises(ValueError, match=r"^mesh: 6 devices not divisible by dcn_data\(4\)$"):
        resolve(ParallelConfig(dcn_data=4), 6)
    with pytest.raises(ValueError, match=r"not divisible by model\(2\)"):
        resolve(ParallelConfig(dcn_data=2, model=2), 2)
