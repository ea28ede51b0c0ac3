"""Sharded checkpoints: the JAX package's cases (`tests/test_sharded_checkpoint.py`)
for the port's `train/sharded_checkpoint.py`.

Four gloo ranks of `tests/_torch_tp_worker.py` (one launch for the module):
* the diffusion trainer at data=2, model=2: one step, a save (every rank
  writes its chunks), a resume on the same layout bit-equal to what was
  saved, and one more step equal to two steps straight; the same
  checkpoint resumed at data=4 (every rank whole) and, in this process,
  by a world of one: the parameters and the EMA are the ranks' chunks put
  together, bit for bit;
* the Llama with experts at expert=2: one step, a save, a resume and a
  step equal to two steps straight; the checkpoint resumed at model=2
  holds the chunks of the saved parameters at the new coordinates;
* each chunk is written once across replicas (by the lowest rank holding
  it), and the index maps every leaf of every tree to its chunks.
In this process: a missing tree, a missing leaf and a shape mismatch
raise; host leaves round-trip; retention spans both formats;
`tree_needs_sharded_save` is true only for a split across processes.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec
from latent_diffusion_speech_tpu_torch.parallel.sharding import local_chunk
from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step, save_checkpoint
from latent_diffusion_speech_tpu_torch.train.sharded_checkpoint import (
    load_checkpoint_sharded,
    save_checkpoint_sharded,
    sharded_checkpoint_dir,
    tree_needs_sharded_save,
)
from tests import _torch_tp_worker as T
from tests.test_torch_expert_parallel import jax_llama  # noqa: F401  (the module's JAX Llama fixture)

ONE = Mesh(MeshSpec(data=1, seq=1, model=1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_llama):  # noqa: F811
    from latent_diffusion_speech_tpu_torch.convert import llama_from_jax

    out = tmp_path_factory.mktemp("ckpt")
    torch.save(llama_from_jax(jax_llama[1]), out / "llama_moe.pt")
    return out, T.launch(out, "ckpt")


def _mesh(layout, coords) -> Mesh:
    return Mesh(MeshSpec(**{"seq": 1, "model": 1, **T.LAYOUTS[layout]}), index=coords[0], coords=coords)


def _whole(res, key, shardings_key="shardings", coords_key="coords", layout="tp") -> dict:
    """The parameters put together from the ranks' chunks."""
    out = {}
    for name in res[0][key]:
        spec = res[0][shardings_key].get(name, ())
        t = None
        for r in res:
            mesh = _mesh(layout, r[coords_key])
            if t is None:
                shape = [n * (mesh.axis_size(a) if a else 1) for n, a in zip(r[key][name].shape, spec)] \
                    if spec else list(r[key][name].shape)
                t = torch.empty(shape, dtype=r[key][name].dtype)
            if spec:
                local_chunk(t, spec, mesh).copy_(r[key][name])
            else:
                t.copy_(r[key][name])
        out[name] = t
    return out


def test_round_trip_on_the_same_layout(ranks):
    _, res = ranks
    for r in res:
        assert r["sharded_save"]
        for name, p in r["saved"].items():
            assert torch.equal(r["restored"][name], p), name


@pytest.mark.parametrize("trainer", ["diffusion", "lm"])
def test_resume_continues_the_run_exactly(ranks, trainer):
    """One step, save, resume, one step equals two steps, bit for bit."""
    _, res = ranks
    for r in res:
        got, want = ((r["resumed"]["params"], r["straight"]) if trainer == "diffusion"
                     else (r["lm_resumed"], r["lm_straight"]))
        for name, p in want.items():
            assert torch.equal(got[name], p), name


def test_each_chunk_is_written_once_across_replicas(ranks):
    out, _ = ranks
    ckpt = sharded_checkpoint_dir(out / "exp_diffusion", 1)
    index = json.loads((ckpt / "index.json").read_text())
    files = {f.name: torch.load(f, weights_only=True) for f in ckpt.glob("shard_p*.pt")}
    assert sorted(files) == [f"shard_p{r}.pt" for r in range(4)]
    keys = [k for f in files.values() for k in f]
    assert len(keys) == len(set(keys))
    listed = [(c["file"], c["key"]) for tree in index["trees"].values() for e in tree.values() for c in e["chunks"]]
    assert sorted(k for _, k in listed) == sorted(keys)
    assert all(c_key in files[f] for f, c_key in listed)
    # model=2 at data=2: ranks 0 and 1 own a split leaf's two chunks, rank 0 the whole ones; ranks 2 and 3
    # hold replicas only
    assert not files["shard_p2.pt"] and not files["shard_p3.pt"] and files["shard_p1.pt"]
    assert set(index["trees"]) == {"params", "opt_state", "ema"}
    assert index["meta"] == {"epoch": 0, "batch_in_epoch": 0}


@pytest.mark.parametrize("onto", ["data4", "one_rank"])
def test_restore_model2_onto_another_layout(ranks, onto):
    out, res = ranks
    whole, whole_ema = _whole(res, "saved"), _whole(res, "saved_ema")
    if onto == "data4":
        got = [(r["onto_dp"], r["onto_dp_ema"]) for r in res]
    else:
        t = T.diffusion_trainer(out / "exp_diffusion")
        assert t.resume() and t.step == 1
        got = [(T.chunks(t), t.ema)]
    for params, ema in got:
        for name, p in whole.items():
            assert torch.equal(params[name], p), name
            assert torch.equal(ema[name], whole_ema[name]), name


def test_restore_expert2_onto_model2(ranks):
    """The Llama saved at expert=2 resumed at model=2: each rank's chunks
    are the saved parameters cut at its new coordinate."""
    _, res = ranks
    whole = _whole(res, "lm_saved", "lm_saved_shardings", "lm_coords", "ep")
    for r in res:
        mesh = _mesh("tp", r["lm_onto_tp_coords"])
        for name, p in whole.items():
            spec = r["lm_onto_tp_shardings"].get(name)
            want = local_chunk(p, spec, mesh) if spec else p
            assert torch.equal(r["lm_onto_tp"][name], want), name
    assert any(any(s) for s in res[0]["lm_onto_tp_shardings"].values())


# -- in this process ---------------------------------------------------------------------------------

def _small_trees():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 6, generator=g), "b": torch.randn(6, generator=g)},
            "extra": {"count": 7, "lr": 0.5, "arr": np.arange(5, dtype=np.int32)}}


@pytest.mark.parametrize("case", ["missing_tree", "missing_leaf", "shape_mismatch"])
def test_load_raises_as_jax(tmp_path, case):
    trees = _small_trees()
    save_checkpoint_sharded(tmp_path, 3, trees, {}, ONE, keep=0)
    template = {"params": {k: v.clone() for k, v in trees["params"].items()}}
    if case == "missing_tree":
        template["opt_state"] = {"x": torch.zeros(1)}
        error, match = KeyError, "no tree 'opt_state'"
    elif case == "missing_leaf":
        template["params"]["z"] = torch.zeros(2)
        error, match = KeyError, "missing leaves: z"
    else:
        template["params"]["w"] = torch.zeros(4, 5)
        error, match = ValueError, r"shape mismatch for params/w: checkpoint \(4, 6\) vs template \(4, 5\)"
    with pytest.raises(error, match=match):
        load_checkpoint_sharded(tmp_path, 3, template, {}, ONE)


def test_host_leaves_round_trip(tmp_path):
    trees = _small_trees()
    save_checkpoint_sharded(tmp_path, 2, trees, {}, ONE, keep=0)
    got = load_checkpoint_sharded(tmp_path, 2, {"params": trees["params"], "extra": {"count": 0, "lr": 0.0,
                                                                                      "arr": np.zeros(5, np.int32)}},
                                  {}, ONE)
    assert got["extra"]["count"] == 7 and isinstance(got["extra"]["count"], int)
    assert got["extra"]["lr"] == 0.5 and isinstance(got["extra"]["lr"], float)
    np.testing.assert_array_equal(got["extra"]["arr"], np.arange(5))
    for k, v in trees["params"].items():
        assert torch.equal(got["params"][k], v)


def test_retention_spans_both_formats(tmp_path):
    trees = _small_trees()
    for step in range(1, 6):
        if step % 2:
            save_checkpoint_sharded(tmp_path, step, trees, {}, ONE, keep=3, meta={"step": step})
        else:
            save_checkpoint(tmp_path, step, trees["params"], keep=3, meta={"step": step})
    names = sorted(p.name for p in tmp_path.glob("model_*"))
    assert names == ["model_3.meta.json", "model_3.sharded", "model_4.ckpt", "model_4.meta.json",
                     "model_5.meta.json", "model_5.sharded"]
    assert latest_checkpoint_step(tmp_path) == 5


def test_needs_sharded_save_only_for_a_split_across_processes():
    split = {"w": ("model", None), "b": (None,)}
    whole = {"w": (None, None)}
    with_group = Mesh(MeshSpec(data=2, seq=1, model=2), group=object())
    assert tree_needs_sharded_save(split, with_group)
    assert not tree_needs_sharded_save(whole, with_group)
    assert not tree_needs_sharded_save(split, Mesh(MeshSpec(data=2, seq=1, model=2)))  # no processes
    assert not tree_needs_sharded_save({"w": ("model", None)}, Mesh(MeshSpec(data=4, seq=1, model=1),
                                                                    group=object()))
