"""One rank of the port's tensor- and expert-parallel CPU checks.

Run as `python tests/_torch_tp_worker.py <out_dir> <group>` with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK);
`launch` starts four.  `group` picks the cases of one test module:
* `tp` (tests/test_torch_tensor_parallel.py): at data=2, model=2 the
  diffusion trainer (with its EMA, again with clipping, and with the
  general denoiser), the RoFormer
  trainer with dropout and the dense Llama, two steps each; the RoFormer's
  teacher-forced logits and greedy tokens served split;
* `ep` (tests/test_torch_expert_parallel.py): the Llama with experts at
  expert=2 (data=2) and at model=2, expert=2, two steps each;
* `ckpt` (tests/test_torch_sharded_checkpoint.py): sharded saves under
  model=2 and expert=2, resumes onto the same and other layouts.
Each rank writes `<group>_rank<r>.pt`: its coordinates, the shardings, the
losses and its chunks of every case.  Imports torch and the port only (no
JAX), so the ranks start quickly; the test modules import the case functions to
run the same cases as a world of one.
"""

from __future__ import annotations

import dataclasses
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

from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig  # noqa: E402
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem  # noqa: E402
from latent_diffusion_speech_tpu_torch.parallel.mesh import shard_batch  # noqa: E402
from latent_diffusion_speech_tpu_torch.parallel.sharding import shard_module  # noqa: E402
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook  # noqa: E402
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer  # noqa: E402
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer  # noqa: E402
from tests import _torch_mp_worker as W  # noqa: E402

WORLD = 4
TIMEOUT = 300
DENSE = {**W.LLAMA_MOE, "moe_experts": 0}
CLIP = 0.05
LAYOUTS = {"tp": dict(data=2, model=2), "ep": dict(data=2, expert=2), "tp_ep": dict(data=1, model=2, expert=2),
           "dp": dict(data=4)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(out: Path, group: str, n: int = WORLD) -> list:
    """Start `n` gloo ranks of this worker on `group`; their results."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(out), group],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
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
    return [torch.load(out / f"{group}_rank{r}.pt") for r in range(n)]


def with_layout(cfg, layout: str):
    for k, v in LAYOUTS.get(layout, {}).items():
        setattr(cfg.parallel, k, v)
    return cfg


# the general (reference-layout) denoiser: its blocks' products split by the same rules
GENERAL = dataclasses.replace(W.UNIT2MEL, denoiser="general", n_hidden=16, block_out_channels=(16, 16))


def diffusion_trainer(expdir, layout: str = "one", clip: bool = False, general: bool = False) -> DiffusionTrainer:
    """The frozen-codebook diffusion case of the data-parallel check (EMA on,
    optimizer state saved); `clip`: clipping at `CLIP`; `general`: the
    general denoiser."""
    cfg = with_layout(W.diffusion_config(expdir), layout)
    if clip:
        cfg.diffusion.train.clip_grad_norm = CLIP
    codebook = np.random.default_rng(2).standard_normal((16, W.UNIT)).astype(np.float32)
    return DiffusionTrainer(cfg, model_cfg=GENERAL if general else W.UNIT2MEL,
                            quantizer=EuclideanCodebook(codebook, device="cpu"), device="cpu")


def lm_trainer(lm_type: str, expdir, layout: str = "one", llama_state=None, experts: bool = False) -> LMTrainer:
    """The RoFormer (dropout 0.1), the dense Llama, or the Llama with
    experts from `llama_state`; optimizer state saved."""
    cfg = with_layout(W.lm_config(expdir, lm_type), layout)
    cfg.text2semantic.train.save_opt = True
    if lm_type == "roformer":
        return LMTrainer(cfg, lm_cfg=W.ROFORMER, device="cpu")
    t = LMTrainer(cfg, lm_cfg=LlamaConfig(**(W.LLAMA_MOE if experts else DENSE)), device="cpu")
    if llama_state is not None:
        from latent_diffusion_speech_tpu_torch.parallel.sharding import local_state

        t.system.module.load_state_dict(local_state(llama_state, t.shardings, t.mesh))
    return t


def served_roformer(layout_mesh=None) -> RoformerSystem:
    """The seeded RoFormer in eval mode, split on `layout_mesh` when given."""
    lm = RoformerSystem(W.ROFORMER, device="cpu", seed=5)
    shard_module(lm.module, layout_mesh)
    return lm


def serve_batch():
    g = np.random.default_rng(11)
    return {"phone": torch.as_tensor(g.integers(1, 50, (2, 12))), "tone": torch.as_tensor(g.integers(0, 5, (2, 12))),
            "semantic": torch.as_tensor(g.integers(0, 40, (2, 9))), "spk_id": torch.ones((2, 12), dtype=torch.long)}


def greedy() -> dict:
    return dict(max_length=16, do_sample=False, temperature=1.0, top_k=1, top_p=1.0, repetition_penalty=1.0)


def serve(lm: RoformerSystem) -> dict:
    b = serve_batch()
    with torch.no_grad():
        logits = lm.logits(b)
        tokens, lengths = lm.generate(b["phone"][:1], b["tone"][:1], **greedy())
    return {"logits": logits, "tokens": tokens, "lengths": lengths}


def chunks(t) -> dict:
    return W.params(t.system.module)


def run_lm(t, batches):
    out = [t.train_step(t.device_put_batch(b)) for b in batches]
    return [float(o["loss"]) for o in out], [float(o["grad_norm"]) for o in out]


def rows(t, batches):
    return [shard_batch(t.mesh, b) for b in batches]


def drops(t):
    return [float(m.drop_fraction) for m in t.system.module.modules()
            if hasattr(m, "drop_fraction") and m.drop_fraction is not None]


def _tp(out: Path, res: dict) -> None:
    t = diffusion_trainer(out / "exp_diffusion", "tp")
    res["mesh"] = {"coords": t.mesh.coords, "index": t.mesh.index, "size": t.mesh.size}
    res["diffusion"] = {"losses": W.run_diffusion(t, rows(t, W.diffusion_batches())), "params": chunks(t),
                        "ema": {k: v.clone() for k, v in t.ema.items()}, "shardings": t.shardings}
    t = diffusion_trainer(out / "exp_clip", "tp", clip=True)
    norms = [float(t.train_step(t.device_put_batch(b), W.step_generator(0, s, "cpu"))["grad_norm"])
             for s, b in enumerate(rows(t, W.diffusion_batches()))]
    res["clip"] = {"norms": norms, "params": chunks(t), "shardings": t.shardings}
    t = diffusion_trainer(out / "exp_general", "tp", general=True)
    res["general"] = {"losses": W.run_diffusion(t, rows(t, W.diffusion_batches())), "params": chunks(t),
                      "shardings": t.shardings}
    for name in ("roformer", "llama"):
        t = lm_trainer(name, out / f"exp_{name}", "tp")
        batches = W.roformer_batches() if name == "roformer" else W.llama_batches()
        losses, _ = run_lm(t, rows(t, batches))
        res[name] = {"losses": losses, "params": chunks(t), "shardings": t.shardings}
    lm = served_roformer(t.mesh)
    res["serve"] = serve(lm)
    res["serve"]["split"] = lm.module.tensor_parallel


def _ep(out: Path, res: dict) -> None:
    state = torch.load(out / "llama_moe.pt")
    for layout in ("ep", "tp_ep"):
        t = lm_trainer("llama", out / f"exp_{layout}", layout, state, experts=True)
        batches = rows(t, W.llama_batches())
        first = t.train_step(t.device_put_batch(batches[0]))
        res[layout] = {"first_drop": drops(t), "losses": [float(first["loss"])]}
        res[layout]["losses"] += run_lm(t, batches[1:])[0]
        res[layout].update(params=chunks(t), shardings=t.shardings, coords=t.mesh.coords)


def _ckpt(out: Path, res: dict) -> None:
    from latent_diffusion_speech_tpu_torch.train import diffusion_trainer as dt

    batches_one = W.diffusion_batches()
    # two steps straight, then one step, a save, a resume and one step
    t = diffusion_trainer(out / "straight", "tp")
    b = rows(t, batches_one)
    W.run_diffusion(t, b)
    res["straight"] = chunks(t)
    res["shardings"], res["coords"] = t.shardings, t.mesh.coords
    t = diffusion_trainer(out / "exp_diffusion", "tp")
    W.run_diffusion(t, b[:1])
    res["saved"] = chunks(t)
    res["saved_ema"] = {k: v.clone() for k, v in t.ema.items()}
    res["sharded_save"] = dt.tree_needs_sharded_save(t.shardings, t.mesh)
    t.save()
    t = diffusion_trainer(out / "exp_diffusion", "tp")
    assert t.resume() and t.step == 1
    res["restored"] = chunks(t)
    res["resumed"] = {"losses": W.run_diffusion(t, b[1:], first_step=1), "params": chunks(t)}
    # model=2 -> data=4: every rank whole
    t = diffusion_trainer(out / "exp_diffusion", "dp")
    assert t.resume() and t.step == 1 and t.shardings == {}
    res["onto_dp"] = chunks(t)
    res["onto_dp_ema"] = {k: v.clone() for k, v in t.ema.items()}

    # the LM: expert=2, one step, a save; resume and a step under expert=2
    # (against two steps straight) and under model=2
    state = torch.load(out / "llama_moe.pt")
    lb = W.llama_batches()
    t = lm_trainer("llama", out / "lm_straight", "ep", state, experts=True)
    run_lm(t, rows(t, lb))
    res["lm_straight"] = chunks(t)
    t = lm_trainer("llama", out / "exp_lm", "ep", state, experts=True)
    run_lm(t, rows(t, lb[:1]))
    res["lm_saved"], res["lm_saved_shardings"], res["lm_coords"] = chunks(t), t.shardings, t.mesh.coords
    t.save()
    t = lm_trainer("llama", out / "exp_lm", "ep", None, experts=True)
    assert t.resume() and t.step == 1
    run_lm(t, rows(t, lb[1:]))
    res["lm_resumed"] = chunks(t)
    t = lm_trainer("llama", out / "exp_lm", "tp", None, experts=True)
    assert t.resume() and t.step == 1
    res["lm_onto_tp"], res["lm_onto_tp_shardings"], res["lm_onto_tp_coords"] = chunks(t), t.shardings, t.mesh.coords


def main(out: Path, group: str) -> None:
    from latent_diffusion_speech_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed("cpu")
    rank = torch.distributed.get_rank()
    res: dict = {}
    {"tp": _tp, "ep": _ep, "ckpt": _ckpt}[group](out, res)
    torch.save(res, out / f"{group}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2])
