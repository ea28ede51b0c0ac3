"""One rank of the port's sequence- and pipeline-parallel CPU checks.

Run as `python tests/_torch_sp_pp_worker.py <out_dir> <group>` with
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK); `start` launches four.  `group` picks the cases of one test
module:
* `ring` (tests/test_torch_ring_attention.py): at seq=4, ring attention's
  chunks and gradients (causal or not, with a key-padding mask), the
  `sequence_parallel` routing of eligible and other calls, and
  `encode_seq_parallel` with the weights the test wrote; at data=2, seq=2
  the LM trainer (the RoFormer with hidden dropout, the Llama dense and
  with experts whose capacity overflows), three steps each;
* `pp` (tests/test_torch_pipeline_parallel.py): at pipe=4, `pipeline_apply`
  (sequential, a pytree activation, gradients, remat) and both LMs'
  `loss_pp` and gradients with the weights the test wrote; at data=2,
  pipe=2 `pipeline_apply` over each microbatch's rows and the Llama with
  experts' `loss_pp` (routing statistics, an overflowing capacity), with
  and without remat; the LM
  trainer at data=2 x pipe=2, model=2 x pipe=2, pipe=2 x expert=2 and
  dcn_data=2, three steps each.
Each rank writes `<group>_rank<r>.pt`.  Imports torch and the port only (no
JAX), so the ranks start quickly; the test modules import the case
functions to run the same cases as a world of one.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from latent_diffusion_speech_tpu_torch.config import Config, ParallelConfig  # noqa: E402
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem  # noqa: E402
from latent_diffusion_speech_tpu_torch.models.lm.roformer import (RoformerConfig, RoformerSystem,  # noqa: E402
                                                                  StackConfig)
from latent_diffusion_speech_tpu_torch.ops import ring_attention as ring  # noqa: E402
from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention, sequence_parallel  # noqa: E402
from latent_diffusion_speech_tpu_torch.ops.moe import data_parallel  # noqa: E402
from latent_diffusion_speech_tpu_torch.parallel.mesh import build_mesh, shard_batch  # noqa: E402
from latent_diffusion_speech_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer  # noqa: E402

WORLD = 4
TIMEOUT = 400
STEPS = 3

# -- shared geometry (the JAX tests' where they have one) ----------------------------------------------------

# tests/test_ring_attention.py::test_roformer_encoder_seq_parallel
ENC_ROFORMER = RoformerConfig(
    encoder=StackConfig(num_hidden_layers=2, hidden_size=32, num_attention_heads=4, intermediate_size=64),
    decoder=StackConfig(num_hidden_layers=1, hidden_size=32, num_attention_heads=4, intermediate_size=64),
    semantic_kmeans_num=16, n_spk=2)
# tests/test_pipeline.py::TestLlamaPipeline / TestRoformerPipeline
PP_LLAMA = dict(hidden_size=32, num_attention_heads=2, num_hidden_layers=4, intermediate_size=48,
                semantic_kmeans_num=32)
PP_ROFORMER = RoformerConfig(
    encoder=StackConfig(num_hidden_layers=3, hidden_size=32, num_attention_heads=2, intermediate_size=48),
    decoder=StackConfig(num_hidden_layers=2, hidden_size=32, num_attention_heads=4, intermediate_size=48),
    semantic_kmeans_num=16, n_spk=4)
# the Llama with experts whose capacity overflows (factor 0.5: half the routed choices find a slot)
MOE_LLAMA = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=2, intermediate_size=32,
                 semantic_kmeans_num=16, moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
PP_M = {"llama": 4, "roformer": 2, "moe": 2}  # loss_pp's microbatches a case

# the trainer cases: layout name -> (axes, [(case, lm type, model config kwargs)])
SEQ_LAYOUTS = {"dp_sp": (dict(data=2, seq=2), ("roformer_dropout", "llama", "llama_moe"))}
PP_LAYOUTS = {"dp_pp": (dict(data=2, pipe=2), ("llama4", "roformer")),
              "tp_pp": (dict(model=2, pipe=2), ("llama4",)),
              "pp_ep": (dict(pipe=2, expert=2), ("llama_moe_ample",)),
              "dcn": (dict(dcn_data=2), ("llama4",))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(out: Path, group: str, n: int = WORLD) -> list:
    """Start `n` gloo ranks of this worker on `group` (`finish` joins them)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(out), group],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(n)]


def finish(procs: list, out: Path, group: str) -> list:
    """The ranks' results, after each exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return [torch.load(out / f"{group}_rank{r}.pt") for r in range(len(procs))]


def chunk(x, c: int, n: int, dim: int = 1):
    t = x.shape[dim] // n
    return x.narrow(dim, c * t, t)


# -- ring attention and the routing ----------------------------------------------------------------------------

def ring_inputs(case: str) -> dict:
    """The JAX tests' inputs (numpy, seeded): `plain` and `grad` q/k/v (and
    the gradient's cotangent mixer `w`), `mask` with key lengths 64, 40, 9
    (9: three of four chunks wholly padded), `grad_mask` one q with key
    lengths 32, 11."""
    g = np.random.default_rng({"plain": 10, "mask": 11, "grad": 12, "grad_mask": 13}[case])
    B, T, H, D = {"plain": (2, 64, 2, 16), "mask": (3, 64, 2, 16), "grad": (2, 32, 2, 8),
                  "grad_mask": (2, 32, 2, 8)}[case]
    out = {k: g.standard_normal((B, T, H, D)).astype(np.float32) for k in ("q", "k", "v", "w")}
    lengths = {"mask": [64, 40, 9], "grad_mask": [32, 11]}.get(case)
    if lengths is not None:
        out["kv_mask"] = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return out


def routing_inputs() -> dict:
    """Self-attention (T=32) with a bias over every key, and cross-attention
    of 32 queries on 64 keys with a key-padding mask."""
    g = np.random.default_rng(14)
    B, H, D = 2, 2, 8
    return {"x": g.standard_normal((B, 32, H, D)).astype(np.float32),
            "bias": g.standard_normal((B, H, 32, 32)).astype(np.float32),
            "q": g.standard_normal((B, 32, H, D)).astype(np.float32),
            "k": g.standard_normal((B, 64, H, D)).astype(np.float32),
            "v": g.standard_normal((B, 64, H, D)).astype(np.float32),
            "kv_mask": np.arange(64)[None, :] < np.asarray([64, 23])[:, None]}


def _ring_cases(mesh, c: int, n: int) -> dict:
    res = {}
    for case in ("plain", "mask", "grad", "grad_mask"):
        a = {k: torch.as_tensor(v) for k, v in ring_inputs(case).items()}
        for causal in (False, True):
            mask = chunk(a["kv_mask"], c, n) if "kv_mask" in a else None
            if case.startswith("grad"):
                q = chunk(a["q"], c, n).clone().requires_grad_()
                if case == "grad":
                    k, v = (chunk(a[x], c, n).clone().requires_grad_() for x in "kv")
                    out = ring.ring_attention(q, k, v, mesh, is_causal=causal)
                    (out * chunk(a["w"], c, n)).sum().backward()
                    res[(case, causal)] = {"dq": q.grad, "dk": k.grad, "dv": v.grad}
                else:
                    out = ring.ring_attention(q, q, q, mesh, is_causal=True, kv_mask=mask)
                    (out ** 2).sum().backward()
                    res[(case, True)] = {"dq": q.grad}
            else:
                q, k, v = (chunk(a[x], c, n) for x in "qkv")
                res[(case, causal)] = {"out": ring.ring_attention(q, k, v, mesh, is_causal=causal, kv_mask=mask)}
    return res


def routing_expected(case: str) -> torch.Tensor:
    """The whole sequence's output (and for `cross_grad` the gradients) of
    each routing case, by the plain path in one process."""
    a = {k: torch.as_tensor(v) for k, v in routing_inputs().items()}
    x, m = a["x"], a["kv_mask"][:, None, None, :]
    if case == "self":
        return dot_product_attention(x, x, x)
    if case == "self_causal_mask":
        return dot_product_attention(x, x, x, mask=a["kv_mask"][:, None, None, :32], is_causal=True)
    if case == "bias":
        return dot_product_attention(x, x, x, bias=a["bias"])
    if case == "fused":
        return dot_product_attention(x, x, x, impl="fused")
    if case in ("cross", "cross_causal"):
        return dot_product_attention(a["q"], a["k"], a["v"], mask=m, is_causal=case == "cross_causal")
    raise ValueError(case)


ROUTING = ("self", "self_causal_mask", "bias", "fused", "cross", "cross_causal")


def _routing_cases(mesh, c: int, n: int) -> dict:
    a = {k: torch.as_tensor(v) for k, v in routing_inputs().items()}
    x = chunk(a["x"], c, n)
    res = {}
    calls = [0]
    real = ring.ring_attention

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    ring.ring_attention = counted
    with sequence_parallel(mesh):
        for case in ROUTING:
            before = calls[0]
            if case == "self":
                out = dot_product_attention(x, x, x)
            elif case == "self_causal_mask":
                km = chunk(a["kv_mask"][:, :32], c, n)[:, None, None, :]
                out = dot_product_attention(x, x, x, mask=km, is_causal=True)
            elif case == "bias":  # this rank's rows of the bias, over every key
                out = dot_product_attention(x, x, x, bias=chunk(a["bias"], c, n, dim=2))
            elif case == "fused":
                out = dot_product_attention(x, x, x, impl="fused")
            else:
                q = chunk(a["q"], c, n).clone().requires_grad_()
                k, v = (chunk(a[t], c, n).clone().requires_grad_() for t in "kv")
                out = dot_product_attention(q, k, v, mask=chunk(a["kv_mask"], c, n)[:, None, None, :],
                                            is_causal=case == "cross_causal")
                out.sum().backward()
                res[case + "_grads"] = {"dq": q.grad, "dk": k.grad, "dv": v.grad}
            res[case] = {"out": out.detach(), "ring": calls[0] - before}
        try:
            dot_product_attention(x, x, x, dropout_rate=0.1, generator=torch.Generator().manual_seed(0))
            res["dropout_raises"] = False
        except ValueError:
            res["dropout_raises"] = True
    ring.ring_attention = real
    return res


def enc_inputs() -> dict:
    g = np.random.default_rng(0)
    B, L = 2, 32
    return {"phone": g.integers(1, 50, (B, L)).astype(np.int64), "tone": g.integers(0, 5, (B, L)).astype(np.int64),
            "spk": np.ones((B, L), np.int64)}


# -- the LM trainer cases --------------------------------------------------------------------------------------

def lm_cfg(expdir, case: str, axes: dict) -> tuple:
    """(Config, model config) of a trainer case."""
    cfg = Config()
    cfg.common.n_spk = 4
    t = cfg.text2semantic.train
    t.expdir, t.warm_up_steps, t.weight_decay, t.interval_log, t.interval_val = str(expdir), 2, 0.01, 10_000, 10_000
    cfg.text2semantic.model.type = "roformer" if case.startswith("roformer") else "llama"
    for k, v in axes.items():
        setattr(cfg.parallel, k, v)
    if case.startswith("roformer"):
        hidden = 0.1 if case == "roformer_dropout" else 0.0
        stack = dict(hidden_size=32, num_attention_heads=2, intermediate_size=48, num_hidden_layers=2,
                     hidden_dropout_prob=hidden, attention_probs_dropout_prob=0.0)
        return cfg, RoformerConfig(encoder=StackConfig(**stack), decoder=StackConfig(**stack),
                                   semantic_kmeans_num=16, n_spk=4)
    if case == "llama_moe":
        return cfg, LlamaConfig(**MOE_LLAMA)
    if case == "llama_moe_ample":
        return cfg, LlamaConfig(**{**MOE_LLAMA, "moe_experts": 2, "moe_top_k": 1, "moe_capacity_factor": 4.0})
    layers = 4 if case == "llama4" else 2
    return cfg, LlamaConfig(**{**PP_LLAMA, "num_hidden_layers": layers, "semantic_kmeans_num": 16})


def lm_batches(case: str, vocab: int) -> list:
    """STEPS global batches of 8 rows (numpy, seeded), padded unevenly;
    the Llama's rows drawn from four corners of the vocabulary, so the
    experts' loads differ by rows."""
    g = np.random.default_rng(5)
    B, L, S, T = 8, 12, 16, 16
    out = []
    for _ in range(STEPS):
        if case.startswith("roformer"):
            pl, sl = g.integers(4, L + 1, B), g.integers(6, S + 1, B)
            em = (np.arange(L)[None] < pl[:, None]).astype(np.int64)
            dm = (np.arange(S)[None] < sl[:, None]).astype(np.int64)
            semantic = g.integers(0, 16, (B, S))
            out.append({"phone": g.integers(1, 40, (B, L)) * em, "tone": g.integers(0, 5, (B, L)),
                        "semantic": semantic, "labels": np.where(dm > 0, semantic, -100),
                        "spk_id": np.repeat(g.integers(1, 5, (B, 1)), L, axis=1),
                        "encoder_attention_mask": em, "attention_mask": dm})
        else:
            q = vocab // 4
            ids = np.concatenate([g.integers(i * q, (i + 1) * q, (2, T)) for i in range(4)])
            mask = (np.arange(T)[None] < g.integers(5, T + 1, B)[:, None]).astype(np.int64)
            out.append({"input_ids": ids, "attention_mask": mask, "labels": np.where(mask > 0, ids, -100)})
    return out


def run_trainer(expdir, case: str, axes: dict) -> dict:
    """STEPS train steps of a case on its layout (a world of one with no
    axes): the losses, the parameters after, the experts' dropped shares,
    the smallest |gradient| each element saw and the steps' summed rate."""
    cfg, model = lm_cfg(expdir, case, axes)
    t = LMTrainer(cfg, lm_cfg=model, device="cpu")
    vocab = getattr(model, "vocab_size", 0)
    small = {n: torch.full_like(p, np.inf) for n, p in t.system.module.named_parameters()}
    real_step = t.optimizer.step

    def step(*a, **k):
        for n, p in t.system.module.named_parameters():
            small[n] = torch.minimum(small[n], p.grad.abs())
        return real_step(*a, **k)

    t.optimizer.step = step
    losses, drops = [], []
    for b in lm_batches(case, vocab):
        losses.append(float(t.train_step(t.device_put_batch(shard_batch(t.mesh, b)))["loss"]))
        drops.append([float(m.drop_fraction) for m in t.system.module.modules()
                      if getattr(m, "drop_fraction", None) is not None])
    return {"losses": losses, "drops": drops, "coords": t.mesh.coords, "spec": t.mesh.shape,
            "params": {k: v.detach().clone() for k, v in t.system.module.state_dict().items()},
            "shardings": t.shardings, "small": small, "lr_steps": sum(t.schedule(k) for k in range(STEPS))}


def check_params(got: dict, one: dict, mesh=None) -> None:
    """`got`'s parameters (chunks under `mesh`'s split) against the world of
    one's at JAX's bounds (rtol 5e-4, atol 1e-5), and within Adam's step
    bound where the world of one saw a rounding-level gradient (a key
    bias's, which the softmax cancels), as the tensor-parallel check
    holds them."""
    from latent_diffusion_speech_tpu_torch.parallel.sharding import local_chunk

    bound = one["lr_steps"] * 0.1 / 0.001 ** 0.5
    for name, want in one["params"].items():
        spec = got["shardings"].get(name, (None,) * want.dim())
        tiny = one["small"].get(name)
        if mesh is not None:
            want = local_chunk(want, spec, mesh)
            tiny = local_chunk(tiny, spec, mesh) if tiny is not None else None
        g = got["params"][name]
        tiny = tiny < 1e-6 if tiny is not None else torch.zeros_like(want, dtype=torch.bool)
        np.testing.assert_allclose(g[~tiny].numpy(), want[~tiny].numpy(), rtol=5e-4, atol=1e-5, err_msg=name)
        if tiny.any():
            assert (g[tiny] - want[tiny]).abs().max().item() <= bound, name


def _ring(out: Path, res: dict) -> None:
    mesh = build_mesh(ParallelConfig(seq=4))
    c, n = mesh.coordinate("seq"), 4
    res["coords"] = mesh.coords
    res["ring"] = _ring_cases(mesh, c, n)
    res["routing"] = _routing_cases(mesh, c, n)
    lm = RoformerSystem(ENC_ROFORMER, state_dict=torch.load(out / "enc_roformer.pt"), device="cpu")
    a = enc_inputs()
    with torch.no_grad():
        res["encode"] = lm.encode_seq_parallel(a["phone"], a["tone"], a["spk"], mesh=mesh)
    for layout, (axes, cases) in SEQ_LAYOUTS.items():
        for case in cases:
            res[f"{layout}/{case}"] = run_trainer(out / f"exp_{layout}_{case}", case, axes)


# -- the pipeline ----------------------------------------------------------------------------------------------

def pipe_inputs(case: str) -> dict:
    """The JAX tests' shapes (numpy, seeded): stage weights `w` (S, D, D),
    biases `b`, activation `x` (M, mb, D), a bool `gate` for `pytree`."""
    S, M, mb, D = {"sequential": (4, 6, 2, 16), "pytree": (4, 5, 2, 8), "grads": (4, 4, 2, 8),
                   "batch_axis": (2, 4, 4, 8), "single": (3, 2, 2, 8)}[case]
    g = np.random.default_rng(20 + ("sequential", "pytree", "grads", "batch_axis", "single").index(case))
    return {"w": (g.standard_normal((S, D, D)) * 0.3).astype(np.float32),
            "b": (g.standard_normal((S, D)) * 0.1).astype(np.float32),
            "x": g.standard_normal((M, mb, D)).astype(np.float32),
            "gate": g.standard_normal((M, mb, D)) > 0}


def stage_tanh(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def stage_gate(p, act):
    h, g = act
    return torch.where(g, torch.tanh(h @ p["w"]), h), g


def _pipe_cases(mesh) -> dict:
    res = {}
    a = {k: torch.as_tensor(v) for k, v in pipe_inputs("sequential").items()}
    res["sequential"] = pipeline_apply(mesh, stage_tanh, {"w": a["w"], "b": a["b"]}, a["x"])
    a = {k: torch.as_tensor(v) for k, v in pipe_inputs("pytree").items()}
    res["pytree"] = pipeline_apply(mesh, stage_gate, {"w": a["w"]}, (a["x"], a["gate"]))
    for remat in (False, True):
        a = {k: torch.as_tensor(v) for k, v in pipe_inputs("grads").items()}
        w, b, x = a["w"].requires_grad_(), a["b"].requires_grad_(), a["x"].requires_grad_()
        (pipeline_apply(mesh, stage_tanh, {"w": w, "b": b}, x, remat=remat) ** 2).sum().backward()
        res["remat" if remat else "grads"] = {"w": w.grad, "b": b.grad, "x": x.grad}
    return res


def pp_inputs(case: str) -> dict:
    """The JAX tests' batches (numpy, seeded): `llama` B=8, T=24 with row
    masks; `roformer` B=8, L=12, S=20 with both masks; `moe` B=4, T=12."""
    if case == "llama":
        g = np.random.default_rng(1)
        B, T = 8, 24
        ids = g.integers(0, LlamaConfig(**PP_LLAMA).vocab_size, (B, T))
        mask = (np.arange(T)[None, :] < g.integers(T // 2, T + 1, B)[:, None]).astype(np.int64)
        return {"input_ids": ids, "labels": np.where(mask > 0, ids, -100), "attention_mask": mask}
    if case == "moe":
        g = np.random.default_rng(3)
        V = LlamaConfig(**MOE_LLAMA).vocab_size
        ids = np.concatenate([g.integers(0, V // 4, (2, 12)), g.integers(3 * V // 4, V, (2, 12))])
        return {"input_ids": ids, "labels": ids.copy()}
    g = np.random.default_rng(2)
    B, L, S = 8, 12, 20
    out = {"phone": g.integers(1, 40, (B, L)), "tone": g.integers(0, 5, (B, L)),
           "semantic": g.integers(0, 16, (B, S)), "labels": g.integers(0, 16, (B, S)),
           "spk_id": np.ones((B, L), np.int64)}
    out["encoder_attention_mask"] = (np.arange(L)[None, :] < g.integers(L // 2, L + 1, B)[:, None]).astype(np.int64)
    out["attention_mask"] = (np.arange(S)[None, :] < g.integers(S // 2, S + 1, B)[:, None]).astype(np.int64)
    out["labels"] = np.where(out["attention_mask"] > 0, out["labels"], -100)
    return out


def microbatch_rows(x: torch.Tensor, M: int, index: int, size: int) -> torch.Tensor:
    """Data coordinate `index`'s rows of each of M microbatches (JAX splits
    each microbatch's rows over `data`)."""
    B = x.shape[0]
    return x.view(M, size, B // (M * size), *x.shape[1:])[:, index].reshape(-1, *x.shape[1:])


def loss_pp_case(case: str, system, mesh, remat: bool = False) -> tuple:
    """(loss, {name: gradient}, drop fractions) of `loss_pp` on this rank's
    rows; under a data axis the denominator is the global count's share and
    the experts route over the data axis, as the trainer runs it."""
    a = {k: torch.as_tensor(v) for k, v in pp_inputs(case).items()}
    M, D = PP_M[case], mesh.size if mesh is not None else 1
    denom = (a["labels"][:, 1:] != -100).sum().float() / D if D > 1 else None
    if D > 1:
        a = {k: microbatch_rows(v, M, mesh.index, D) for k, v in a.items()}
    with data_parallel(system.module, mesh) if D > 1 else contextlib.nullcontext():
        if case == "roformer":
            loss = system.loss_pp(a["phone"], a["tone"], a["semantic"], a["labels"], mesh, spk_id=a["spk_id"],
                                  encoder_attention_mask=a["encoder_attention_mask"],
                                  attention_mask=a["attention_mask"], microbatches=M, remat=remat, denom=denom)
        else:
            loss = system.loss_pp(a["input_ids"], a["labels"], mesh, attention_mask=a.get("attention_mask"),
                                  microbatches=M, remat=remat, denom=denom)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in system.module.named_parameters()}
    drops = [float(m.drop_fraction) for m in system.module.modules() if getattr(m, "drop_fraction", None) is not None]
    return float(loss), grads, drops


def _pp(out: Path, res: dict) -> None:
    mesh = build_mesh(ParallelConfig(pipe=4))
    res["coords"] = mesh.coords
    res["pipe"] = _pipe_cases(mesh)
    llama = LlamaSystem(LlamaConfig(**PP_LLAMA), state_dict=torch.load(out / "pp_llama.pt"), device="cpu",
                        training=True)
    res["loss_pp/llama"] = loss_pp_case("llama", llama, mesh)
    rof = RoformerSystem(PP_ROFORMER, state_dict=torch.load(out / "pp_roformer.pt"), device="cpu", training=True)
    res["loss_pp/roformer"] = loss_pp_case("roformer", rof, mesh)
    mesh = build_mesh(ParallelConfig(data=2, pipe=2))
    res["dp_coords"] = mesh.coords
    a = {k: torch.as_tensor(v) for k, v in pipe_inputs("batch_axis").items()}
    x = a["x"][:, mesh.index * 2:(mesh.index + 1) * 2]
    res["batch_axis"] = pipeline_apply(mesh, stage_tanh, {"w": a["w"], "b": a["b"]}, x)
    for remat in (False, True):  # remat recomputes each stage routed over `data`, as its forward was
        moe = LlamaSystem(LlamaConfig(**MOE_LLAMA), state_dict=torch.load(out / "pp_moe.pt"), device="cpu",
                          training=True)
        res["loss_pp/moe_remat" if remat else "loss_pp/moe"] = loss_pp_case("moe", moe, mesh, remat=remat)
    for layout, (axes, cases) in PP_LAYOUTS.items():
        for case in cases:
            res[f"{layout}/{case}"] = run_trainer(out / f"exp_{layout}_{case}", case, axes)


def main(out: Path, group: str) -> None:
    from latent_diffusion_speech_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed("cpu")
    rank = torch.distributed.get_rank()
    res: dict = {}
    {"ring": _ring, "pp": _pp}[group](out, res)
    torch.save(res, out / f"{group}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2])
