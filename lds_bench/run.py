"""One run of one cell of the benchmark.

    python3 -m lds_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for.  Set-up draws the weights and the requests on the card from the
seed, builds the program's pipeline from them, and serves each distinct
shape of the cell once; then a closed loop of one caller sends requests
back to back for `--seconds`.  With `--trace 0` the last line of standard
output is the cell's end-to-end metrics; with `--trace 1` the window's
first calls run under the profiler and the line holds the per-layer
metrics.  After the window the plain reference answers a sample of the
served requests and `correct` says whether every number compared is within
its limit (`check.py`); the numbers and limits close standard error and
the result line.  The program's kernel build and Triton caches live in
`lds_bench/_cache/` inside the checkout.

PyTorch's CPU work runs on `HOST_THREADS` threads, whatever the machine's
core count.  `setup_s` holds the kernel library's load, and on a
checkout's first run its nvcc build; `device.build_s` and `device.built`
show that part.  `host` in the result line records what the host did in
the window: the process's CPU seconds a second and involuntary context
switches, and where /proc/stat moves, the machine's busy and stolen share.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional

_T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (from /proc; at import where
    that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()

from lds_bench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "latent_diffusion_speech_tpu")
HOST_THREADS = 1


def setup_clock() -> float:
    """Seconds from the process's start to now."""
    return _AGE0 + time.perf_counter() - _T0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's name begins with the package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Call:
    frames: int
    batch: int
    bucket: int
    start: float
    end: float
    audio_s: float
    wav: object = None
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read."""

    cfg: dict
    device_name: str
    setup_s: float
    calls: List[Call]
    window_s: float
    trace: object = None

    @property
    def served(self) -> List[Call]:
        return [c for c in self.calls if c.error is None]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def host_reading() -> dict:
    """This process's CPU seconds and involuntary context switches, and
    the machine's CPU jiffies (busy, stolen, all) where /proc/stat reads."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        out.update(busy=v[0] + v[1] + v[2] + v[5] + v[6], steal=v[7], all=sum(v))
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_window(a: dict, b: dict, window_s: float) -> dict:
    """What the host did between two `host_reading`s of one window."""
    import torch

    out = {"threads": torch.get_num_threads(), "cpus": len(os.sched_getaffinity(0)),
           "process_cpu_per_s": (b["cpu_s"] - a["cpu_s"]) / window_s,
           "involuntary_switches": b["nivcsw"] - a["nivcsw"]}
    ticks = b.get("all", 0) - a.get("all", 0)
    if ticks > 0:
        out.update(steal_pct=100.0 * (b["steal"] - a["steal"]) / ticks,
                   machine_busy_pct=100.0 * (b["busy"] - a["busy"]) / ticks)
    return out


def prepare(cfg: dict, traffic: dict, seed: int, device):
    """(the configuration with the traffic's sampler, Unit2Mel weights,
    vocoder weights, requests), all drawn from `seed` on `device`."""
    import torch

    from lds_bench import traffic as traffic_mod, weights
    from lds_bench.reference.acoustic import unit2mel_spec, vocoder_spec

    cfg = {**cfg, **traffic["sampler"]}
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg["dtype"])
    u2m_w = weights.draw(unit2mel_spec(cfg), gen, device, dtype)
    voc_w = weights.draw(vocoder_spec(cfg["vocoder"]), gen, device, dtype)
    weights.scale_vocoder_input(voc_w, cfg)
    book = weights.codebook(cfg, gen, device)
    return cfg, u2m_w, voc_w, traffic_mod.requests(traffic, cfg, seed, book, gen)


def run_cell(cfg: dict, traffic: dict, e2e: List[dict], layers: List[dict], seed: int, seconds: float, trace: bool,
             device, build: Optional[Callable] = None, serve: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object.  `build` and `serve`
    default to the program's (`program.py`)."""
    import torch

    from lds_bench import check, program
    from lds_bench.reference.acoustic import bucket
    from lds_bench.trace import SpanRecorder, StageSpans, Trace, collect, no_span, start_profiler

    build = build or program.build
    serve = serve or program.serve
    sampler = traffic["sampler"]
    cfg, u2m_w, voc_w, reqs = prepare(cfg, traffic, seed, device)
    hop = math.prod(cfg["vocoder"]["upsample_rates"])
    sr = cfg["vocoder"]["sampling_rate"]
    cuda = device.type == "cuda"
    kernels = program.load_kernels() if cuda else {}
    pipe = build(cfg, u2m_w, voc_w, device)
    warm = set()
    for r in reqs:  # every shape this cell sends, once
        if (r.batch, bucket(r.frames)) not in warm:
            warm.add((r.batch, bucket(r.frames)))
            serve(pipe, r, sampler)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = setup_clock()

    span_fn = SpanRecorder() if trace else no_span
    spans = StageSpans(pipe, span_fn) if trace else None
    prof, traced = None, None
    if trace:
        prof, marker = start_profiler(device)
    calls: List[Call] = []
    host0 = host_reading()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while not calls or time.perf_counter() < deadline:
        r = reqs[len(calls) % len(reqs)]
        err, wav = None, None
        t0 = time.perf_counter()
        try:
            with span_fn("lds.call"):
                wav = serve(pipe, r, sampler, span_fn)
        except Exception:  # a failed request counts against the run, and the window goes on
            err = traceback.format_exc()
            print(err, file=sys.stderr)
        t1 = time.perf_counter()
        calls.append(Call(r.frames, r.batch, bucket(r.frames), t0, t1, r.batch * r.frames * hop / sr, wav, err))
        if prof is not None and traced is None and len(calls) == traffic["trace_calls"]:
            prof.stop()
            traced = (calls[:], list(span_fn.spans))
    t_end = time.perf_counter()
    host = host_window(host0, host_reading(), t_end - t_start)
    if prof is not None and traced is None:
        prof.stop()
        traced = (calls[:], list(span_fn.spans))

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cfg, torch.cuda.get_device_name(device) if cuda else "cpu", setup_s, calls, t_end - t_start)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name, "count": 1,
                   "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        evals = cfg["k_step_max"] // cfg["infer_speedup"]
        ops, shift = collect(prof, marker)
        run.trace = Trace(ops, traced[1], [dict(frames=c.frames, batch=c.batch, bucket=c.bucket, audio_s=c.audio_s)
                                           for c in traced[0]], evals)
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s, clock_shift_ns=shift)
        breakdown = run.trace.breakdown()
        prof = None
    if cuda:
        device_info.update(power_limit_w=power_limit_w(), **kernels)

    wanted = layers if trace else e2e
    metrics = {}
    for m in wanted:
        value = manifest.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    pipe = spans = run.trace = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = check.sample([c.frames for c in calls], seed, traffic["check_calls"])
    checked = [(reqs[i % len(reqs)], calls[i].wav) for i in picked]
    numbers = check.compare(u2m_w, voc_w, cfg, checked)
    limits = cfg["limits"]
    failed = sum(c.batch for c in calls if c.error is not None)
    result = {
        "correct": failed == 0 and check.verdict(numbers, limits),
        "attempted": sum(c.batch for c in calls),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["host"] = host
    # JSON has no infinity: a check that read none (a failed call) shows the largest float
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else sys.float_info.max,
                            "limit": limits[k]} for k in limits}
    return result


def set_cache_env() -> None:
    """The program's kernel build and Triton caches: fixed directories
    inside the checkout, so that only a checkout's first run builds."""
    cache = manifest.HERE / "_cache"
    os.environ["LDS_TORCH_BUILD_DIR"] = str(cache / "torch_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_env()
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(manifest.config(cell["config"]), manifest.traffic(cell["traffic"]),
                      manifest.end_to_end(bench, args.workload), manifest.per_layer(bench, args.workload),
                      args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    print(f"host {json.dumps(result['host'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
