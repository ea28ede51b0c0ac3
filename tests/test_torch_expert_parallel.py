"""Expert parallelism on torch.distributed: the Llama with experts on four
CPU ranks at expert=2 (data=2) and at model=2, expert=2 (data=1), against
the JAX package's `LlamaSystem.loss` and a world of one.

The JAX Llama with 4 experts is seeded, then its router sharpened, its
expert outputs and logits scaled (as `tests/test_torch_parallel.py` does),
and moved to the port with `convert.llama_from_jax`; the capacity factor is
0.5, so routed choices are dropped.  Each layout's ranks (one launch of
`tests/_torch_tp_worker.py` for the module) run two trainer steps:
* the first step's loss equals JAX `LlamaSystem.loss` on the global batch
  (rtol 1e-5): the routing, the capacity, the slots and the Switch loss are
  the data axis's batch's whatever `expert` is;
* the dropped share of every layer equals the world of one's;
* every rank of an expert group reports the same losses and holds the same
  replicated parameters (bit for bit);
* losses at rtol 1e-5 and each rank's chunks after two steps at the
  data-parallel check's bounds against the world of one.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaSystem as JLlamaSystem
from latent_diffusion_speech_tpu_torch.convert import llama_from_jax
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec
from tests import _torch_mp_worker as W
from tests import _torch_tp_worker as T
from tests.test_torch_tensor_parallel import _check_chunks, _grads_after

LAYOUTS = ["ep", "tp_ep"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_llama():
    jlm = JLlamaSystem(JLlamaConfig(**W.LLAMA_MOE), seed=0)
    scale = {"gate": 30.0, "w_down": 10.0, "lm_head": 30.0}

    def scaled(path, x):
        keys = [getattr(k, "key", None) for k in path]
        return np.asarray(x) * np.prod([scale.get(k, 1.0) for k in keys])

    params = jax.tree_util.tree_map_with_path(scaled, jlm.params)
    jlm.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jlm, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_llama):
    out = tmp_path_factory.mktemp("ep")
    torch.save(llama_from_jax(jax_llama[1]), out / "llama_moe.pt")
    return out, T.launch(out, "ep")


@functools.lru_cache(maxsize=None)
def _world_one(out: str):
    """(losses, the first step's dropped shares, parameters, the smallest |gradient|, the schedule)."""
    out = Path(out)
    t = T.lm_trainer("llama", out / "one", "one", torch.load(out / "llama_moe.pt"), experts=True)
    losses, drops = [], None
    small = {n: torch.full_like(p, np.inf) for n, p in t.system.module.named_parameters()}
    for b in W.llama_batches():
        result = {}
        grads = _grads_after(t, lambda b=b: result.update(t.train_step(t.device_put_batch(b))))
        losses.append(float(result["loss"]))
        drops = T.drops(t) if drops is None else drops
        for n, g in grads.items():
            small[n] = torch.minimum(small[n], g.abs())
    return losses, drops, W.params(t.system.module), small, t.schedule


def _mesh(layout, coords) -> Mesh:
    axes = {"seq": 1, "model": 1, **T.LAYOUTS[layout]}
    return Mesh(MeshSpec(**axes), index=coords[0], coords=coords)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_first_loss_is_jax_global_batch_loss(ranks, jax_llama, layout):
    _, res = ranks
    jlm, _ = jax_llama
    batch = W.llama_batches()[0]
    want = float(jax.jit(jlm.loss)(jlm.params, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"]),
                                   jnp.asarray(batch["attention_mask"])))
    for r in res:
        np.testing.assert_allclose(r[layout]["losses"][0], want, rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dropped_share_equals_world_of_one(ranks, layout):
    out, res = ranks
    _, drops, _, _, _ = _world_one(str(out))
    assert max(drops) > 0.1  # capacity factor 0.5 drops routed choices
    for r in res:
        np.testing.assert_allclose(r[layout]["first_drop"], drops, rtol=0, atol=1e-7)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_of_an_expert_group_agree_bit_for_bit(ranks, layout):
    _, res = ranks
    assert all(r[layout]["losses"] == res[0][layout]["losses"] for r in res)
    shardings = res[0][layout]["shardings"]
    assert any(any(s) for n, s in shardings.items() if ".moe.w_" in n)
    for name, p in res[0][layout]["params"].items():
        if not any(shardings.get(name, ())):
            for r in res[1:]:
                assert torch.equal(p, r[layout]["params"][name]), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_trainer_steps_equal_world_of_one(ranks, layout):
    out, res = ranks
    losses, _, params, small, schedule = _world_one(str(out))
    lr_steps = sum(schedule(k) for k in range(W.STEPS))
    for r in res:
        np.testing.assert_allclose(r[layout]["losses"], losses, rtol=1e-5)
        _check_chunks(r[layout]["params"], params, small, r[layout]["shardings"], _mesh(layout, r[layout]["coords"]),
                      lr_steps)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_banks_are_split_as_jax_lays_them(ranks, layout):
    """`w_gate` / `w_up` (E, C, F) over (expert, -, model), `w_down` over
    (expert, model, -); at expert=2 alone the model axis drops out."""
    _, res = ranks
    sh = res[0][layout]["shardings"]
    model = "model" if layout == "tp_ep" else None
    assert sh["block_0.moe.w_gate"] == ("expert", None, model)
    assert sh["block_0.moe.w_down"] == ("expert", model, None)
    assert sh["block_0.moe.gate"] == (None, None)
    assert res[0][layout]["params"]["block_0.moe.w_gate"].shape[0] == W.LLAMA_MOE["moe_experts"] // 2
