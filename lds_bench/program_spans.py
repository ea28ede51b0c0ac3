"""The program's own spans and counters, as the per-layer metrics read them.

The port's tracer (`latent_diffusion_speech_tpu_torch/utils/profiler.py`)
records host spans `(name, request, parent, start ns, end ns)` and counters
while a `torch.profiler` session runs, so in a `--trace 1` run it records
over exactly the traced calls, on the clock the benchmark's spans and the
aligned device operations share (`time.time_ns`).  `of(run)` drains it
once per run; it is None where the program has no such tracer (an older
commit), where nothing was traced, or where the traced calls do not each
hold one `tts.infer` span, and the metrics that read it then find nothing.

The program's spans stay apart from the benchmark's (`Trace.spans`), so
no reader of those sees them.  `breakdown` labels each idle gap of the
device by the innermost span of either kind open at its midpoint: a
program span by its own name, a benchmark span by its `GAP_LABELS` text.

    python3 -m lds_bench.program_spans --workload <cell> --seed <n> --seconds <s> [--out <file.json>]

makes one traced run of the cell exactly as `lds_bench.run --trace 1`
does (its result line on standard output), then writes the idle gaps so
labelled and the program's host self time per span and call, as JSON, to
`--out` (and a summary to standard error).
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from lds_bench.trace import GAP_LABELS, Interval, gaps, innermost, union

ProgramSpan = Tuple[str, int, Optional[str], int, int]  # (name, request, parent, start ns, end ns)

KEEP = False  # set by `main`: `of` then keeps the last run's traces in LAST
LAST: dict = {}


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from latent_diffusion_speech_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "drain") else None


@dataclass
class ProgramTrace:
    """The program's spans inside one traced window, by start, and its
    counters over the traced calls."""

    spans: List[ProgramSpan]
    counters: Dict[str, int]
    calls: int
    evals: int  # denoiser evaluations the traced calls make

    def named(self, name: str) -> List[ProgramSpan]:
        return [s for s in self.spans if s[0] == name]

    def total_ns(self, name: str, parent: Optional[str] = None) -> int:
        """Summed duration of the spans `name` (whose parent is `parent`, where given)."""
        return sum(e - s for n, _, p, s, e in self.spans if n == name and (parent is None or p == parent))

    def self_ms_per_call(self) -> Dict[str, float]:
        """Each span name's host self time (its duration less its children's)
        in ms per traced call."""
        out: Dict[str, int] = {}
        for name, _, parent, s, e in self.spans:
            out[name] = out.get(name, 0) + (e - s)
            if parent is not None:
                out[parent] = out.get(parent, 0) - (e - s)
        return {k: v / 1e6 / self.calls for k, v in sorted(out.items(), key=lambda kv: -kv[1])}

    def dispatch_ms_per_eval(self) -> Optional[float]:
        """Host ms in each `denoiser.eval` less the phase-table builds in it;
        None unless every evaluation of the traced calls has its span."""
        n = len(self.named("denoiser.eval"))
        if n == 0 or n != self.evals:
            return None
        ns = self.total_ns("denoiser.eval") - self.total_ns("unet_fused.table_build", parent="denoiser.eval")
        return ns / 1e6 / n

    def prep_ms_per_call(self) -> Optional[float]:
        """Host ms a call spends preparing the denoiser's weights and its
        kernel's phase tables; None unless every call has one preparation."""
        if len(self.named("diffusion.prepare")) != self.calls:
            return None
        return (self.total_ns("diffusion.prepare") + self.total_ns("unet_fused.table_build")) / 1e6 / self.calls

    def table_builds_per_call(self) -> float:
        return self.counters.get("unet_fused.table_builds", 0) / self.calls

    def padded_frame_share(self) -> Optional[float]:
        """% of the frames the denoiser ran that no caller asked for."""
        denoised = self.counters.get("diffusion.frames_denoised", 0)
        if not denoised:
            return None
        return 100.0 * (1.0 - self.counters.get("tts.frames_requested", 0) / denoised)


def of(run) -> Optional[ProgramTrace]:
    """The program's trace of `run`'s traced calls (drained from the tracer
    at the first call, kept on `run` for the next readers), or None."""
    if "_program_trace" in vars(run):
        return run._program_trace
    found = None
    t = tracer()
    if t is not None and run.trace is not None:
        spans, counters = t.drain()
        lo, hi = run.trace.lo, run.trace.hi
        spans = sorted((s for s in spans if lo <= s[3] and s[4] <= hi), key=lambda s: s[3])
        calls = len(run.trace.calls)
        found = ProgramTrace(spans, counters, calls, run.trace.evals_per_call * calls)
        if len(found.named("tts.infer")) != calls:
            found = None
    run._program_trace = found
    if KEEP:
        LAST.update(trace=run.trace, program=found)
    return found


def breakdown(trace, program: Optional[ProgramTrace], n: int = 10) -> dict:
    """The `n` longest idle gaps of the traced window, each labelled by the
    innermost span open at its midpoint (a program span by its name, a
    benchmark span by its `GAP_LABELS` text), and the idle seconds under
    each label over the whole window."""
    spans: List[Interval] = list(trace.spans)
    if program is not None:
        spans += [(name, s, e) for name, _, _, s, e in program.spans]
    spans.sort(key=lambda x: x[1])

    def label(t: int) -> str:
        name = innermost(spans, t)
        return GAP_LABELS.get(name, "other") if name is None or name.startswith("lds.") else name

    idle = gaps(union(trace.ops, trace.lo, trace.hi), trace.lo, trace.hi)
    by_label: Dict[str, float] = {}
    for s, e in idle:
        key = label((s + e) // 2)
        by_label[key] = by_label.get(key, 0.0) + (e - s) / 1e9
    idle.sort(key=lambda g: g[0] - g[1])
    return {"idle_gaps": [[label((s + e) // 2), (e - s) / 1e9] for s, e in idle[:n]],
            "idle_s_by_label": dict(sorted(by_label.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    # this module under its own name, as the metric readers import it (not `__main__`)
    from lds_bench import program_spans, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    program_spans.KEEP = True
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                   "--trace", "1"])
    last = program_spans.LAST
    if rc != 0 or last.get("program") is None:
        print("no program spans were read in this run", file=sys.stderr)
        return rc or 1
    program = last["program"]
    report = {"workload": args.workload, "seed": args.seed, "calls": program.calls,
              **breakdown(last["trace"], program), "self_ms_per_call": program.self_ms_per_call(),
              "counters": program.counters}
    for key in ("idle_gaps", "idle_s_by_label", "self_ms_per_call"):
        print(f"{key} {json.dumps(report[key])}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
