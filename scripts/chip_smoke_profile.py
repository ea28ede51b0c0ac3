"""Where `chip_smoke.py`'s wall time goes: its main thread's stack, sampled.

`run` executes `chip_smoke.py` as `python3 chip_smoke.py` would (same
arguments, same exit code) while a daemon thread samples the main thread's
stack every `--every` seconds and appends one JSON line a sample to
`--out`: `[seconds since start, frames]`, where frames are the
`chip_smoke.py` frames from the outside in, then `["..."]`, then the four
innermost frames, each `[file name, function, line]`.  Sampling costs a
few percent of one core.  `report` reads such a file and prints the
seconds spent under each phase (the function `run_phases` or `main`
called), under each call one level down, and under a few library
categories (child processes, module initialisation, checkpoint writes):

    python3 scripts/chip_smoke_profile.py run [--out exp/chip_smoke_stacks.jsonl] [--every 0.2]
    python3 scripts/chip_smoke_profile.py report exp/chip_smoke_stacks.jsonl [--top 40]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "chip_smoke.py"
PHASE_CALLERS = ("run_phases", "main")
# substrings of a sample's frames -> a category of library time
CATEGORIES = {
    "waits on child processes": ("communicate", "subprocess.py:wait", "spawn.py", "join"),
    "module initialisation": ("init.py:", "init_weights", "reset_parameters"),
    "checkpoint writes": ("serialization.py:_save",),
}


def run(out: str, every: float) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fh = open(out, "w")
    main_id = threading.main_thread().ident
    t_start = time.perf_counter()

    def sample() -> None:
        while True:
            time.sleep(every)
            frame = sys._current_frames().get(main_id)
            stack = []
            while frame is not None:
                stack.append((os.path.basename(frame.f_code.co_filename), frame.f_code.co_name, frame.f_lineno))
                frame = frame.f_back
            stack.reverse()
            keep = [f for f in stack if f[0] == SMOKE] + [["..."]] + stack[-4:]
            fh.write(json.dumps([round(time.perf_counter() - t_start, 2), keep]) + "\n")
            fh.flush()

    threading.Thread(target=sample, daemon=True).start()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    sys.argv = [os.path.join(ROOT, SMOKE)]
    try:
        runpy.run_path(os.path.join(ROOT, SMOKE), run_name="__main__")
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    return 0


def report(path: str, top: int) -> None:
    rows = [json.loads(line) for line in open(path)]
    every = (rows[-1][0] - rows[0][0]) / max(1, len(rows) - 1) if len(rows) > 1 else 0.0
    phases, calls, cats = collections.Counter(), collections.Counter(), collections.Counter()
    for _, stack in rows:
        smoke = [f for f in stack if f[0] == SMOKE]
        names = [f[1] for f in smoke]
        at = max((i for i, n in enumerate(names) if n in PHASE_CALLERS), default=None)
        sub = smoke[at + 1:] if at is not None else []
        phase = sub[0][1] if sub else (f"{names[at]}:{smoke[at][2]}" if at is not None else "<outside>")
        phases[phase] += 1
        if len(sub) > 1:
            calls[(phase, f"{sub[1][1]}:{sub[1][2]}")] += 1
        elif sub:
            calls[(phase, f"line {sub[0][2]}")] += 1
        text = " ".join(f"{f[0]}:{f[1]}" for f in stack if len(f) == 3)
        for cat, keys in CATEGORIES.items():
            if any(k in text for k in keys):
                cats[cat] += 1
    print(f"{len(rows)} samples, every {every:.3f} s: {len(rows) * every:.1f} s")
    print("seconds by phase:")
    for name, n in phases.most_common():
        print(f"  {n * every:8.1f}  {name}")
    print(f"seconds by call under a phase (top {top}):")
    for (phase, call), n in calls.most_common(top):
        print(f"  {n * every:8.1f}  {phase} > {call}")
    print("seconds by category (a sample may fall in several):")
    for cat, n in cats.most_common():
        print(f"  {n * every:8.1f}  {cat}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run chip_smoke.py with the sampler")
    r.add_argument("--out", default=os.path.join(ROOT, "exp", "chip_smoke_stacks.jsonl"))
    r.add_argument("--every", type=float, default=0.2)
    p = sub.add_parser("report", help="summarise a samples file")
    p.add_argument("path")
    p.add_argument("--top", type=int, default=40)
    args = ap.parse_args()
    if args.cmd == "run":
        return run(args.out, args.every)
    report(args.path, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
