"""The LM training step with the backward in PyTorch's deterministic mode
(as `LMTrainer.train_step` runs it) against the atomic embedding backward.

Builds `LMTrainer` at `configs/config.yaml`'s full LM width (4 + 1 layers,
C=256, B=32, f32, dropout 0.1) with seeded weights, makes one seeded batch
per semantic bucket, and times `train_step` on each in turns (deterministic,
atomic, atomic, deterministic; `--reps` steps a turn after a warm-up), each
step synchronised.  Needs a CUDA card:

    python3 scripts/lm_backward_ab.py [--buckets 448 672 1024] [--reps 5]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from functools import partial
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=[448, 672, 1024])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lm_backward_ab: no CUDA device", file=sys.stderr)
        return 2
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.data.lm_dataset import collate_text_batch
    from latent_diffusion_speech_tpu_torch.train import lm_trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    trainer = lm_trainer.LMTrainer(cfg, device="cuda")
    m, B = trainer.lm_cfg, cfg.text2semantic.train.batch_size
    collate = partial(collate_text_batch, phone_pad=m.phone_pad, semantic_pad=m.semantic_pad)
    rng = np.random.default_rng(args.seed)
    batches = []
    for s in args.buckets:
        items = []
        for _ in range(B):
            n = int(rng.integers(s - 31, s + 1))
            p = n // 7
            items.append({"phone": rng.integers(1, 100, p).astype(np.int32),
                          "tone": rng.integers(0, 4, p).astype(np.int32),
                          "semantic": rng.integers(0, m.semantic_kmeans_num, n).astype(np.int32),
                          "spk_id": np.full(p, int(rng.integers(0, cfg.common.n_spk)), np.int32)})
        batches.append(trainer.device_put_batch(collate(items)))

    def step_ms(b) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for b in batches:  # warm-up
        trainer.train_step(b)
    times = {"deterministic": [], "atomic": []}
    for mode in ("deterministic", "atomic", "atomic", "deterministic"):
        ctx = lm_trainer.deterministic_algorithms if mode == "deterministic" else contextlib.nullcontext
        with mock.patch.object(lm_trainer, "deterministic_algorithms", ctx):
            times[mode].append([[step_ms(b) for _ in range(args.reps)] for b in batches])
    print(f"card: {card}")
    for i, s in enumerate(args.buckets):
        d, a = (float(np.median([t for turn in times[k] for t in turn[i]])) for k in ("deterministic", "atomic"))
        print(f"S={s} (B={B}, f32): train_step median {d:.2f} ms deterministic, {a:.2f} ms atomic, "
              f"{d - a:+.2f} ms ({2 * args.reps} steps each, in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
