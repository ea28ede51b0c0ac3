"""Data parallelism on torch.distributed: two CPU ranks over gloo against one
process on the whole batch, and the mesh's checks against JAX's.

The module starts two ranks of `tests/_torch_mp_worker.py` once (a gloo
group, torchrun's environment); they train every case on their rows of the
global batches and write their results.  Each case is then held:
* rank to rank: the same losses and the same parameters, bit for bit (one
  all-reduce gives both ranks the same averages);
* world of two against a world of one fed the same global batch, in this
  process: losses at rtol 1e-5 and parameters after the steps at atol
  1e-6, f32 reassociation (two half-batch sums and an average, where one
  process sums the batch once) moved through two AdamW updates; Adam moves
  an element whose gradient sits at rounding level by up to lr (1 - b1) /
  sqrt(1 - b2) a step whatever its sign, so elements whose world-of-one
  gradient is below 1e-6 are held to that bound (tests/test_torch_lm_train.py's);
* the diffusion trainer with a frozen codebook (device-collated batches, so
  the latent noise is drawn by rows) and with the learned VQ (its EMA
  statistics over the global batch; the EMA of the parameters too);
* the RoFormer with dropout (masks by rows), its ranks holding 45 and 8
  valid targets: a mean of the ranks' means is far from the global loss;
* the Llama with experts at capacity factor 0.5 (routed choices dropped),
  its ranks' tokens from opposite ends of the vocabulary: the world-of-two
  loss equals the JAX package's `LlamaSystem.loss` on the global batch
  (rtol 1e-5, tests/test_torch_llama.py's), and a capacity counted on one
  rank's tokens gives another loss;
* a codec step with the learned VQ;
* one step, a save, a resume and one more step equal to two steps, with
  exactly one checkpoint written, by rank 0;
* unequal local batch shapes raise JAX's error on both ranks.
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.config import ParallelConfig as JParallelConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaSystem as JLlamaSystem
from latent_diffusion_speech_tpu.parallel.mesh import _resolve_spec as j_resolve_spec
from latent_diffusion_speech_tpu_torch.config import Config, ParallelConfig
from latent_diffusion_speech_tpu_torch.convert import llama_from_jax
from latent_diffusion_speech_tpu_torch.parallel import dryrun
from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec, RowGenerator, _resolve_spec, randn
from latent_diffusion_speech_tpu_torch.parallel.mesh import shard_batch
from latent_diffusion_speech_tpu_torch.train.devices import check_parallel_fits
from latent_diffusion_speech_tpu_torch.train.optim import step_generator
from tests import _torch_mp_worker as W

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_llama():
    """The JAX Llama with experts, seeded, then a sharper router (x 30),
    larger expert outputs (x 10) and logits (x 30), so routing is decided
    and a dropped choice moves the loss; its parameters as numpy."""
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
    """Both ranks' results: one launch of two gloo ranks for every case."""
    out = tmp_path_factory.mktemp("dp")
    torch.save(llama_from_jax(jax_llama[1]), out / "llama_moe.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"), str(out)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return out, [torch.load(out / f"rank{r}.pt") for r in range(2)]


# -- a world of one: the same cases on the whole batches, in this process --------------------


def _grads_after(trainer, step_fn) -> dict:
    """Run `step_fn` and return the parameters' gradients as AdamW saw them."""
    seen = {}
    orig = trainer.optimizer.step

    def step(*a, **k):
        seen.update({n: p.grad.detach().clone() for n, p in trainer._named})
        return orig(*a, **k)

    trainer.optimizer.step = step
    step_fn()
    return seen


@functools.lru_cache(maxsize=None)
def _world_one(case: str, out: str):
    """(losses, parameters, the smallest |gradient| an element saw, extra)."""
    out = Path(out)
    extra = {}
    if case in ("frozen", "vq"):
        t = W.diffusion_trainer_for(case, out / f"one_{case}")
        module, batches = t.system.module, W.diffusion_batches()
        steps = [lambda b=b, s=s: t.train_step(t.device_put_batch(b), step_generator(0, s, "cpu"))
                 for s, b in enumerate(batches)]
    elif case in ("roformer", "llama"):
        state = torch.load(out / "llama_moe.pt") if case == "llama" else None
        t = W.lm_trainer_for(case, out / f"one_{case}", state)
        module, batches = t.system.module, (W.roformer_batches() if case == "roformer" else W.llama_batches())
        steps = [lambda b=b: t.train_step(t.device_put_batch(b)) for b in batches]
    if case == "codec":
        t = W.codec_trainer_for(out / "one_codec")
        m = t.train_step(W.codec_audio(), step_generator(0, 0, "cpu"))
        params = {**W.params(t.encoder), **W.params(t.generator),
                  **{f"disc.{k}": v for k, v in W.params(t.disc).items()}}
        return [m["disc/loss"], m["gen/loss"]], params, None, {"vq_state": t.vq_state._asdict()}
    t._named = list(module.named_parameters())
    losses, small = [], {n: torch.full_like(p, np.inf) for n, p in t._named}
    for fn in steps:
        result = {}
        grads = _grads_after(t, lambda: result.update(fn()))
        losses.append(float(result["loss"]))
        for n, g in grads.items():
            small[n] = torch.minimum(small[n], g.abs())
    if case in ("frozen", "vq"):
        extra["ema"] = t.ema
        if case == "vq":
            extra["vq_state"] = t.vq_state._asdict()
    return losses, W.params(module), small, extra


def _check_params(got: dict, want: dict, small, lr_steps: float) -> None:
    # Adam's bound for an element whose gradient is at rounding level
    bound = lr_steps * 0.1 / 0.001 ** 0.5
    for name, w in want.items():
        g = got[name]
        tiny = small.get(name) if small is not None else None
        if tiny is None or not torch.is_floating_point(w):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)
            continue
        tiny = tiny < 1e-6
        torch.testing.assert_close(g[~tiny], w[~tiny], atol=1e-6, rtol=0, msg=name)
        if tiny.any():
            assert (g[tiny] - w[tiny]).abs().max().item() <= bound, name


CASES = ["frozen", "vq", "roformer", "llama", "codec"]


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(ranks, case):
    """Both ranks report the same losses and hold the same parameters."""
    _, (r0, r1) = ranks
    assert r0[case]["losses"] == r1[case]["losses"]
    for name, p in r0[case]["params"].items():
        assert torch.equal(p, r1[case]["params"][name]), name


@pytest.mark.parametrize("case", CASES)
def test_world_of_two_equals_world_of_one(ranks, case):
    out, (r0, _) = ranks
    losses, params, small, extra = _world_one(case, str(out))
    np.testing.assert_allclose(r0[case]["losses"], losses, rtol=1e-5)
    if case == "codec":
        lr_steps = 2e-4
    elif case in ("frozen", "vq"):
        t = W.diffusion_trainer_for(case, out / "sched")
        lr_steps = sum(t.schedule(k) for k in range(W.STEPS))
    else:
        lr_steps = sum(W.lm_trainer_for("roformer", out / "sched").schedule(k) for k in range(W.STEPS))
    _check_params(r0[case]["params"], params, small, lr_steps)
    if "ema" in extra:  # a mean of the parameters: their bound
        _check_params(r0[case]["ema"], extra["ema"], small, lr_steps)
    if "vq_state" in extra:
        for name, want in extra["vq_state"].items():
            torch.testing.assert_close(r0[case]["vq_state"][name], want, atol=1e-6, rtol=0, msg=f"vq_state {name}")


def _halves(batch):
    return [{k: torch.as_tensor(v[r * 2:(r + 1) * 2]) for k, v in batch.items()} for r in range(2)]


def test_lm_ranks_hold_unequal_counts_so_a_mean_of_means_is_wrong(ranks):
    """The RoFormer case's ranks hold 45 and 8 valid targets: the global
    loss and the mean of the two ranks' own losses differ by far more than
    the tolerance (no dropout here, the weights as built)."""
    out, _ = ranks
    t = W.lm_trainer_for("roformer", out / "means")
    batch = W.roformer_batches()[0]
    counts = [int((h["labels"][:, 1:] != -100).sum()) for h in _halves(batch)]
    assert counts == [45, 8]
    with torch.no_grad():
        whole = t.system.loss({k: torch.as_tensor(v) for k, v in batch.items()}).item()
        means = [t.system.loss(h).item() for h in _halves(batch)]
    assert abs(np.mean(means) - whole) > 1e-3 * abs(whole)


def test_moe_loss_is_jax_global_batch_loss_and_not_a_per_rank_capacity(ranks, jax_llama):
    """The world-of-two Llama-MoE loss of the first step (before any update)
    equals the JAX `LlamaSystem.loss` on the global batch; the ranks drop
    routed choices; routing each rank's tokens with its own capacity gives
    a loss more than ten times the tolerance away."""
    out, (r0, _) = ranks
    jlm, _ = jax_llama
    batch = W.llama_batches()[0]
    want = float(jax.jit(jlm.loss)(jlm.params, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"]),
                                   jnp.asarray(batch["attention_mask"])))
    np.testing.assert_allclose(r0["llama"]["losses"][0], want, rtol=1e-5)
    assert max(r0["llama"]["drop"]) > 0.1
    t = W.lm_trainer_for("llama", out / "per_rank", torch.load(out / "llama_moe.pt"))
    sums, counts, auxes = [], [], []
    with torch.no_grad():
        for h in _halves(batch):
            logits, aux = t.system.module(h["input_ids"].long(), h["attention_mask"])
            sums.append(t.system._ce(logits, h["labels"].long(), torch.tensor(1.0)).item())
            counts.append(int((h["labels"][:, 1:] != -100).sum()))
            auxes.append(torch.stack(aux).mean().item())
    per_rank = sum(sums) / sum(counts) + t.system.cfg.moe_aux_weight * np.mean(auxes)
    assert abs(per_rank - want) > 10 * 1e-5 * abs(want)


def test_checkpoint_written_by_rank_0_and_resume_equals_two_steps(ranks):
    out, (r0, r1) = ranks
    assert r0["resume"]["writes"] == [0] and r1["resume"]["writes"] == []
    assert sorted(p.name for p in (out / "exp_resume").glob("model_*.ckpt")) == ["model_1.ckpt", "model_1.ema.ckpt"]
    assert r0["resume"]["losses"] == r0["frozen"]["losses"][1:]
    for name, p in r0["frozen"]["params"].items():
        assert torch.equal(r0["resume"]["params"][name], p), name
        assert torch.equal(r1["resume"]["params"][name], p), name


def test_unequal_local_shapes_raise_on_every_rank(ranks):
    _, (r0, r1) = ranks
    for r in (r0, r1):
        assert r["unequal"] is not None and r["unequal"].startswith(
            "global_shard_batch: local batch shape") and "does not tile the 'data' axis (size 2)" in r["unequal"]


# -- the mesh without processes ---------------------------------------------------------------

SPECS = [dict(), dict(data=4), dict(data=2, model=2), dict(seq=2), dict(model=3), dict(data=3),
         dict(data=2, pipe=2), dict(expert=2, data=-1), dict(model=2, seq=2, pipe=2)]


@pytest.mark.parametrize("kw", SPECS, ids=[str(k) for k in SPECS])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_resolve_spec_matches_jax(kw, n):
    """The same spec, or the same ValueError message, as JAX's."""
    try:
        want = j_resolve_spec(JParallelConfig(**kw), n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            _resolve_spec(ParallelConfig(**kw), n)
        assert str(err.value) == str(e)
        return
    got = _resolve_spec(ParallelConfig(**kw), n)
    assert (got.data, got.seq, got.model, got.pipe, got.expert, got.total) == (
        want.data, want.seq, want.model, want.pipe, want.expert, want.total)


@pytest.mark.parametrize("axis", ["model", "seq", "pipe", "expert", "dcn_data"])
def test_other_axes_still_raise_naming_item_10(axis, monkeypatch, tmp_path):
    """Every axis passes the check on a world of two, and the LM trainer
    builds on that mesh (a rank's view: coordinate 0, no process group):
    the RoFormer split over `model`, the Llama's banks over `expert`, the
    Llama at `seq`, `pipe` and `dcn_data` (two slices stacked on `data`);
    the RoFormer with its shipped attention dropout raises JAX's ValueError
    at `seq`, and with any dropout at `pipe`."""
    cfg = Config()
    setattr(cfg.parallel, axis, 2)
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig
    from latent_diffusion_speech_tpu_torch.parallel.mesh import resolve
    from latent_diffusion_speech_tpu_torch.train import devices
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    monkeypatch.setattr(devices, "process_count", lambda: 2)
    check_parallel_fits(cfg)
    mesh = Mesh(resolve(cfg.parallel, 2))
    assert mesh.shape["data" if axis == "dcn_data" else axis] == 2
    if axis in ("seq", "pipe"):
        match = "attention_probs_dropout" if axis == "seq" else "requires dropout off"
        with pytest.raises(ValueError, match=match):
            LMTrainer(W.lm_config(tmp_path, "roformer"), lm_cfg=W.ROFORMER, device="cpu", mesh=mesh)
    lm_type = "roformer" if axis == "model" else "llama"
    lm_cfg = W.ROFORMER if axis == "model" else LlamaConfig(**W.LLAMA_MOE)
    trainer = LMTrainer(W.lm_config(tmp_path, lm_type), lm_cfg=lm_cfg, device="cpu", mesh=mesh)
    split = {n for n, s in trainer.shardings.items() if any(s)}
    assert bool(split) == (axis in ("model", "expert"))
    assert all((".moe.w_" in n) == (axis == "expert") for n in split)
    assert trainer._share_axes == (("data", "seq", "pipe") if axis in ("seq", "pipe") else ("data",))


def test_data_axis_that_does_not_fit_the_world_raises_jax_error():
    cfg = Config()
    cfg.parallel.data = 2
    want = r"^mesh: data\(2\)\*seq\(1\)\*model\(1\)\*pipe\(1\)\*expert\(1\) != devices\(1\)$"
    with pytest.raises(ValueError, match=want):
        check_parallel_fits(cfg)
    cfg.parallel.data = 1
    check_parallel_fits(cfg)


def test_shard_batch_and_row_draws_keep_the_ranks_rows():
    """Rank r of a data axis of 2 keeps rows [r n, (r + 1) n); a row draw
    is the whole batch's draw cut the same way."""
    batch = {"x": np.arange(12).reshape(6, 2), "s": np.float32(3.0), "odd": np.arange(3)}
    for r in range(2):
        mesh = Mesh(MeshSpec(data=2, seq=1, model=1), index=r)
        got = shard_batch(mesh, batch)
        np.testing.assert_array_equal(got["x"], batch["x"][3 * r:3 * r + 3])
        np.testing.assert_array_equal(got["odd"], batch["odd"])  # 3 rows do not split over 2 ranks
        whole = torch.randn((6, 5), generator=torch.Generator().manual_seed(7))
        rows = randn((3, 5), RowGenerator(torch.Generator().manual_seed(7), mesh))
        assert torch.equal(rows, whole[3 * r:3 * r + 3])


def test_dryrun_refuses_the_layouts_that_are_not_ported():
    """JAX's nine layouts are all served (`dryrun.LAYOUTS`, with JAX's
    axes); a layout that does not fit the ranks, or that JAX has not,
    raises ValueError."""
    assert set(dryrun.LAYOUTS) == {"data-parallel", "dp-tp", "seq-parallel", "pipeline", "roformer-pipeline",
                                   "expert-parallel", "tp-ep", "dp-tp-pp", "pp-ep"}
    assert not hasattr(dryrun, "NOT_PORTED")
    for layout in ("pipeline", "roformer-pipeline", "dp-tp-pp", "pp-ep"):
        with pytest.raises(ValueError, match="does not fit 2 devices"):
            dryrun.dryrun_multichip(2, layouts=(layout,))
    with pytest.raises(ValueError, match="unknown dryrun layout"):
        dryrun.dryrun_multichip(2, layouts=("ring",))
    assert {lay for lay in dryrun.LAYOUTS if dryrun.fits(lay, 2)} == {"data-parallel", "dp-tp", "seq-parallel"}
    assert all(dryrun.fits(lay, 8) for lay in dryrun.LAYOUTS)


def test_dryrun_multichip_runs_a_step_of_each_trainer_on_two_ranks(capfd):
    dryrun.dryrun_multichip(2)
    out = capfd.readouterr().out
    for name in ("diffusion", "roformer", "llama", "llama-moe", "seq-parallel/roformer"):
        assert f"dryrun_multichip(2): {name} ok" in out
