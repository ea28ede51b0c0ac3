"""Tensor parallelism on torch.distributed: the port's parameter shardings
against the JAX package's rules, and four CPU ranks at data=2, model=2
against one process on the whole batch.

* Shape level, in this process: for the flagship Unit2Mel, the shipped
  RoFormer and the Llama with 8 experts at their shipped widths, the port's
  spec of every parameter, mapped to the flax layout, equals the JAX
  package's `infer_param_shardings` on the same model's tree, leaf for
  leaf (237 of 690 UNet leaves split at data=4, model=2); JAX's rule cases
  (indivisible dimensions stay whole, a model axis of 1 splits nothing).
* Four gloo ranks of `tests/_torch_tp_worker.py` (one launch for the
  module): the diffusion trainer, the RoFormer trainer with dropout and
  the dense Llama, two steps each at data=2, model=2 (and the diffusion
  trainer with the general denoiser, whose block zoo's products the same
  rules split), are held
  - rank to rank inside a model group: the same losses, the same
    replicated parameters, bit for bit;
  - against a world of one fed the same global batch: losses at rtol 1e-5,
    parameters after the two steps at the data-parallel check's bounds
    (`tests/test_torch_parallel.py`: atol 1e-6, Adam's step bound where a
    gradient sits at rounding level);
  - each rank's chunk against the world of one's parameter cut at its
    coordinate (that bound too);
* with clipping on, the clipped update equals the world of one's (every
  rank clips by the norm of the global gradients);
* the RoFormer served split over the model axis: its teacher-forced logits
  and greedy tokens equal one process's.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.config import ParallelConfig as JParallelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2Mel as JUnit2Mel
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.lm.llama import Llama as JLlama
from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
from latent_diffusion_speech_tpu.models.lm.roformer import Roformer as JRoformer
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh as j_build_mesh
from latent_diffusion_speech_tpu.parallel.sharding import _path_str, infer_param_shardings as j_infer
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel, Unit2MelConfig
from latent_diffusion_speech_tpu_torch.models.lm.llama import Llama, LlamaConfig
from latent_diffusion_speech_tpu_torch.models.lm.roformer import Roformer, RoformerConfig
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from latent_diffusion_speech_tpu_torch.parallel.sharding import flax_view, infer_param_shardings, local_chunk
from latent_diffusion_speech_tpu_torch.train.optim import step_generator
from tests import _torch_mp_worker as W
from tests import _torch_tp_worker as T


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the rules against JAX's, leaf for leaf ------------------------------------------------------------

def _jax_specs(tree, mesh) -> dict:
    """{flax path: spec padded to the leaf's dims} of JAX's rules."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(j_infer(tree, mesh))[0]:
        leaf = functools.reduce(lambda t, k: t[k.key], path, tree)
        out[_path_str(path)] = tuple(s.spec) + (None,) * (len(leaf.shape) - len(s.spec))
    return out


def _port_specs(module, mesh) -> dict:
    """{flax path: the port's spec in the flax layout}."""
    specs = infer_param_shardings(module, mesh)
    out = {}
    for mname, m in module.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            fleaf, perm = flax_view(m, leaf, p.ndim)
            spec = specs[f"{mname}.{leaf}" if mname else leaf]
            out["/".join([*mname.split("."), fleaf] if mname else [fleaf])] = tuple(spec[d] for d in perm)
    return out


def _models():
    u = jax.eval_shape(lambda: JUnit2Mel(JUnit2MelConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 1280)), volume=None, spk_id=jnp.ones((1, 8), jnp.int32),
        aug_shift=jnp.zeros((1, 8))))["params"]
    a = jnp.zeros((1, 4), jnp.int32)
    r = jax.eval_shape(lambda: JRoformer(JRoformerConfig()).init(jax.random.PRNGKey(0), a, a, a, spk_id=a))["params"]
    llama = jax.eval_shape(lambda: JLlama(JLlamaConfig(moe_experts=8)).init(jax.random.PRNGKey(0), a))["params"]
    with torch.device("meta"):
        port = {"unit2mel": Unit2Mel(Unit2MelConfig()), "roformer": Roformer(RoformerConfig()),
                "llama": Llama(LlamaConfig(moe_experts=8))}
    return {"unit2mel": (u, port["unit2mel"], dict(data=4, model=2)),
            "roformer": (r, port["roformer"], dict(data=4, model=2)),
            "llama": (llama, port["llama"], dict(data=2, model=2, expert=2))}


MODELS = ["unit2mel", "roformer", "llama"]
# (split leaves, leaves, split bytes (f32)) of JAX's rules at the shipped widths: the Llama is
# JAX's default LlamaConfig with 8 experts (q/k/v and o_proj over model, the banks over both axes)
SPLIT = {"unit2mel": (237, 690, 348.79e6), "roformer": (57, 104, 11.56e6), "llama": (28, 43, 188.74e6)}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", MODELS)
def test_port_shardings_equal_jax_rules_leaf_for_leaf(models, name):
    tree, module, axes = models[name]
    want = _jax_specs(tree, j_build_mesh(JParallelConfig(**axes)))
    got = _port_specs(module, Mesh(MeshSpec(**{"seq": 1, "model": 1, **axes})))
    assert sorted(got) == sorted(want)
    assert got == want
    split = [k for k, s in want.items() if any(a is not None for a in s)]
    n_split, n_all, nbytes = SPLIT[name]
    assert (len(split), len(want)) == (n_split, n_all)
    size = {k: int(np.prod(x.shape)) * 4 for k, x in
            ((_path_str(p), x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0])}
    assert abs(sum(size[k] for k in split) - nbytes) < 0.01e6


def test_rules_split_attention_and_ff_and_keep_the_rest():
    """JAX's first rule case in the port's layout: a (out, in) weight is
    split on dim 0 for a column-parallel layer, its bias with it."""
    from torch import nn

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.to_q = nn.Linear(16, 16, bias=False)
            self.ff_in = nn.Linear(16, 32)
            self.other = nn.Linear(3, 3)

    specs = infer_param_shardings(M(), Mesh(MeshSpec(data=4, seq=1, model=2)))
    assert specs == {"to_q.weight": ("model", None), "ff_in.weight": ("model", None), "ff_in.bias": ("model",),
                     "other.weight": (None, None), "other.bias": (None,)}


@pytest.mark.parametrize("case", ["indivisible", "model_1"])
def test_rule_cases_of_jax(case):
    """Indivisible dims stay replicated; a model axis of 1 splits nothing."""
    from torch import nn

    class M(nn.Module):
        def __init__(self, out):
            super().__init__()
            self.to_q = nn.Linear(16, out, bias=False)

    if case == "indivisible":
        module, spec = M(15), MeshSpec(data=4, seq=1, model=2)
    else:
        module, spec = M(16), MeshSpec(data=8, seq=1, model=1)
    assert infer_param_shardings(module, Mesh(spec)) == {"to_q.weight": (None, None)}


# -- four ranks at data=2, model=2 against a world of one ------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    return out, T.launch(out, "tp")


def _grads_after(trainer, step_fn) -> dict:
    seen = {}
    orig = trainer.optimizer.step

    def step(*a, **k):
        seen.update({n: p.grad.detach().clone() for n, p in trainer.system.module.named_parameters()})
        return orig(*a, **k)

    trainer.optimizer.step = step
    step_fn()
    return seen


@functools.lru_cache(maxsize=None)
def _world_one(case: str, out: str):
    """(losses, grad norms, parameters, the smallest |gradient| an element saw, the EMA)."""
    out = Path(out)
    if case in ("diffusion", "clip", "general"):
        t = T.diffusion_trainer(out / f"one_{case}", clip=case == "clip", general=case == "general")
        steps = [lambda b=b, s=s: t.train_step(t.device_put_batch(b), step_generator(0, s, "cpu"))
                 for s, b in enumerate(W.diffusion_batches())]
    else:
        t = T.lm_trainer(case, out / f"one_{case}")
        batches = W.roformer_batches() if case == "roformer" else W.llama_batches()
        steps = [lambda b=b: t.train_step(t.device_put_batch(b)) for b in batches]
    losses, norms = [], []
    small = {n: torch.full_like(p, np.inf) for n, p in t.system.module.named_parameters()}
    for fn in steps:
        result = {}
        grads = _grads_after(t, lambda: result.update(fn()))
        losses.append(float(result["loss"]))
        norms.append(float(result["grad_norm"]))
        for n, g in grads.items():
            small[n] = torch.minimum(small[n], g.abs())
    return losses, norms, W.params(t.system.module), small, getattr(t, "ema", None), t.schedule


def _mesh_of(res) -> Mesh:
    return Mesh(MeshSpec(data=2, seq=1, model=2), index=res["mesh"]["index"], coords=res["mesh"]["coords"])


def _check_chunks(got: dict, want: dict, small: dict, shardings: dict, mesh: Mesh, lr_steps: float) -> None:
    bound = lr_steps * 0.1 / 0.001 ** 0.5  # Adam's step bound at rounding-level gradients
    for name, w in want.items():
        spec = shardings.get(name, (None,) * w.dim())
        w, g, tiny = local_chunk(w, spec, mesh), got[name], local_chunk(small[name], spec, mesh) < 1e-6
        assert g.shape == w.shape, name
        torch.testing.assert_close(g[~tiny], w[~tiny], atol=1e-6, rtol=0, msg=name)
        if tiny.any():
            assert (g[tiny] - w[tiny]).abs().max().item() <= bound, name


CASES = ["diffusion", "general", "roformer", "llama"]


@pytest.mark.parametrize("case", CASES + ["clip"])
def test_ranks_of_a_model_group_agree_bit_for_bit(ranks, case):
    """Ranks 0 and 1 (one model group) and 2 and 3 report the same losses;
    every replicated parameter is the same on all four ranks."""
    _, res = ranks
    key = "norms" if case == "clip" else "losses"
    assert res[0][case][key] == res[1][case][key] == res[2][case][key] == res[3][case][key]
    shardings = res[0][case]["shardings"]
    for name, p in res[0][case]["params"].items():
        if not any(shardings.get(name, ())):
            for r in res[1:]:
                assert torch.equal(p, r[case]["params"][name]), name
    # a split one is the same across the data axis (ranks 0 and 2 hold chunk 0)
    split = [n for n, s in shardings.items() if any(s)]
    assert split
    for name in split:
        assert torch.equal(res[0][case]["params"][name], res[2][case]["params"][name]), name


@pytest.mark.parametrize("case", CASES)
def test_world_of_four_equals_world_of_one(ranks, case):
    out, res = ranks
    losses, _, params, small, ema, schedule = _world_one(case, str(out))
    lr_steps = sum(schedule(k) for k in range(W.STEPS))
    for r in res:
        np.testing.assert_allclose(r[case]["losses"], losses, rtol=1e-5)
        _check_chunks(r[case]["params"], params, small, r[case]["shardings"], _mesh_of(r), lr_steps)
        if case == "diffusion":
            _check_chunks(r[case]["ema"], ema, small, r[case]["shardings"], _mesh_of(r), lr_steps)


def test_each_rank_holds_only_its_chunk(ranks):
    """A split parameter's chunk is 1 / model of it: no rank keeps it whole."""
    out, res = ranks
    params = _world_one("diffusion", str(out))[2]
    shardings = res[0]["diffusion"]["shardings"]
    for name, spec in shardings.items():
        d = [i for i, a in enumerate(spec) if a is not None]
        if d:
            assert res[0]["diffusion"]["params"][name].shape[d[0]] * 2 == params[name].shape[d[0]], name


def test_clipped_update_equals_world_of_one(ranks):
    """Clipping at 0.05 (below every step's norm): the ranks' norms are
    the world of one's and so are the clipped updates."""
    out, res = ranks
    _, norms, params, small, _, schedule = _world_one("clip", str(out))
    assert min(norms) > T.CLIP
    lr_steps = sum(schedule(k) for k in range(W.STEPS))
    for r in res:
        np.testing.assert_allclose(r["clip"]["norms"], norms, rtol=1e-5)
        _check_chunks(r["clip"]["params"], params, small, r["clip"]["shardings"], _mesh_of(r), lr_steps)


def test_split_roformer_serves_as_one_process(ranks):
    """The RoFormer split over model=2 (plain decode: K1 holds a whole
    model): teacher-forced logits at 2e-5 and the same greedy tokens."""
    _, res = ranks
    want = T.serve(T.served_roformer())
    for r in res:
        assert r["serve"]["split"]
        torch.testing.assert_close(r["serve"]["logits"], want["logits"], rtol=2e-4, atol=2e-5)
        assert torch.equal(r["serve"]["tokens"], want["tokens"])
        assert torch.equal(r["serve"]["lengths"], want["lengths"])


def test_rows_follow_the_data_coordinate(ranks):
    """Ranks 0, 1 hold data coordinate 0 and ranks 2, 3 coordinate 1."""
    _, res = ranks
    assert [r["mesh"]["index"] for r in res] == [0, 0, 1, 1]
    assert [r["mesh"]["coords"][2] for r in res] == [0, 1, 0, 1]
    assert all(r["mesh"]["size"] == 2 for r in res)


def test_build_mesh_of_a_world_of_one_is_unchanged():
    mesh = build_mesh()
    assert mesh.group is None and mesh.shape["model"] == 1 and not mesh.model_parallel
