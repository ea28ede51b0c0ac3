"""The readings the limits of `check.py` are set from, on the chip.

    python3 -m lds_bench.calibrate --workload <cell> --seeds 1,2,3 [--control]

For each seed: the weights and requests a run of the cell draws from it,
the program's answers to the requests a run checks (`check.sample` over
one dealt deck: the longest length and others drawn from the seed), the
float32 reference's, and with `--control` the reference computed through
float8 e4m3 products (the control: the nearest precision below the
configuration's bf16).  Prints one line per seed with the program's and the
control's `wav_rel_err`, and writes them to `chiprun_out/calibrate_<cell>.jsonl`
when that directory exists.  The program is built once and takes each
seed's weights through `load_state_dict`.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from lds_bench import check, manifest, program
from lds_bench.run import forbidden_modules, prepare, set_cache_env


def readings(cfg: dict, traffic: dict, seeds, control: bool, device, log=None):
    """One row per seed: the program's and the control's `wav_rel_err`."""
    pipe, rows = None, []
    for seed in seeds:
        t0 = time.perf_counter()
        run_cfg, u2m_w, voc_w, reqs = prepare(cfg, traffic, seed, device)
        if pipe is None:
            pipe = program.build(run_cfg, u2m_w, voc_w, device)
        else:
            pipe.diffusion.module.load_state_dict(u2m_w)
            pipe.vocoder.generator.load_state_dict(voc_w)
        picked = check.sample([r.frames for r in reqs], seed, traffic["check_calls"])
        served = [(reqs[i], program.serve(pipe, reqs[i], traffic["sampler"])) for i in picked]
        W, V = check.reference_weights(u2m_w, voc_w, run_cfg)
        row = {"seed": seed, "frames": [reqs[i].frames for i in picked], "program": 0.0,
               "control": 0.0 if control else None}
        for request, wav in served:
            ref = check.reference_answers(W, V, run_cfg, request)
            row["program"] = max([row["program"]] + check.rel_gaps(wav, ref))
            if control:
                low = check.reference_answers(W, V, run_cfg, request, precision="fp8")
                row["control"] = max([row["control"]] + check.rel_gaps(low.cpu().numpy(), ref))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if log is not None:
            log.write(json.dumps(row) + "\n")
            log.flush()
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    set_cache_env()
    import torch

    cell = manifest.workload(manifest.load(), args.workload)
    out = Path("chiprun_out")
    log = open(out / f"calibrate_{args.workload}.jsonl", "a") if out.is_dir() else None
    readings(manifest.config(cell["config"]), manifest.traffic(cell["traffic"]),
             [int(s) for s in args.seeds.split(",")], args.control, torch.device("cuda", 0), log)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
