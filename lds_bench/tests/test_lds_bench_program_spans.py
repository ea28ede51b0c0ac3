"""The program's own spans and counters (`program_spans.py`) and the
metrics that read them: on a synthetic trace, and in whole runs at tiny
widths on the CPU, with the program's tracer and without one."""

import pytest
import torch

from lds_bench import manifest, program_spans
from lds_bench.run import Call, Run, run_cell
from lds_bench.tests import tiny
from lds_bench.trace import Trace

MS = 1_000_000
BENCH = manifest.load()
CELLS = {"flagship.solo": ("flagship", "solo"), "general.b32": ("general", "b32")}
NEW = {"flagship.solo": {"dispatch_ms_per_eval", "prep_ms_per_call", "table_builds_per_call", "padded_frame_share"},
       "general.b32": {"dispatch_ms_per_eval.b32", "padded_frame_share.b32"}}
OLD = [m["name"] for m in BENCH["per_layer"] if not any(m["name"] in names for names in NEW.values())]


def synthetic():
    """Two calls of 2 evaluations: the benchmark's spans, the program's
    spans inside them (the first evaluation of a call builds a phase
    table), the device's operations, and the program's counters."""
    spans, program, ops = [], [], []
    for r, t in enumerate((0, 100 * MS), start=1):
        spans += [("lds.call", t, t + 90 * MS), ("lds.diffusion", t + 1 * MS, t + 60 * MS),
                  ("lds.denoise", t + 3 * MS, t + 20 * MS), ("lds.denoise", t + 30 * MS, t + 45 * MS),
                  ("lds.vocoder", t + 61 * MS, t + 80 * MS), ("lds.host_copy", t + 81 * MS, t + 89 * MS)]
        at = lambda a, b: (t + int(a * MS), t + int(b * MS))  # noqa: E731
        program += [("tts.infer", r, None, *at(0.5, 80.5)), ("diffusion.sample", r, "tts.infer", *at(1.5, 59.5)),
                    ("diffusion.prepare", r, "diffusion.sample", *at(2, 2.5)),
                    ("denoiser.eval", r, "diffusion.sample", *at(3.5, 19.5)),
                    ("unet_fused.table_build", r, "denoiser.eval", *at(4, 9)),
                    ("denoiser.eval", r, "diffusion.sample", *at(30.5, 44.5)),
                    ("vocoder.infer", r, "tts.infer", *at(61.5, 79.5))]
        ops += [("unet_fwd_kernel<bf16>", t + 10 * MS, t + 20 * MS), ("add", t + 21 * MS, t + 22 * MS),
                ("unet_fwd_kernel<bf16>", t + 35 * MS, t + 45 * MS), ("conv", t + 62 * MS, t + 80 * MS),
                ("Memcpy DtoH", t + 82 * MS, t + 88 * MS)]
    counters = {"unet_fused.table_builds": 2, "tts.frames_requested": 800, "diffusion.frames_denoised": 896}
    calls = [dict(frames=400, batch=1, bucket=448, audio_s=5.0)] * 2
    return Trace(ops, spans, calls, 2), (program, counters)


class FakeTracer:
    def __init__(self, recorded):
        self.recorded = recorded

    def drain(self):
        out, self.recorded = self.recorded, ([], {})
        return out


def run_of(trace):
    cfg = manifest.config("flagship")
    cfg.update(infer_speedup=50)
    return Run(cfg, "NVIDIA H100 80GB HBM3", 10.0, [Call(400, 1, 448, 0.0, 0.1, 5.0)], 0.2, trace)


def reader(name):
    return manifest.metric_reader(name).read


@pytest.fixture
def traced(monkeypatch):
    """A run of the synthetic trace whose program recorded its spans."""
    trace, recorded = synthetic()
    monkeypatch.setattr(program_spans, "tracer", lambda: FakeTracer(recorded))
    return run_of(trace)


def test_program_metrics_from_the_synthetic_trace(traced):
    assert reader("dispatch_ms_per_eval")(traced) == pytest.approx((2 * (16 + 14) - 2 * 5) / 4)  # builds taken out
    assert reader("dispatch_ms_per_eval.b32")(traced) == reader("dispatch_ms_per_eval")(traced)
    assert reader("prep_ms_per_call")(traced) == pytest.approx(0.5 + 5)
    assert reader("table_builds_per_call")(traced) == 1.0
    assert reader("padded_frame_share")(traced) == pytest.approx(100 * (1 - 800 / 896))
    assert reader("padded_frame_share.b32")(traced) == reader("padded_frame_share")(traced)
    self_ms = program_spans.of(traced).self_ms_per_call()
    assert self_ms["denoiser.eval"] == pytest.approx(16 + 14 - 5)
    assert self_ms["diffusion.sample"] == pytest.approx(58 - 0.5 - 16 - 14)


def test_idle_gaps_take_the_innermost_span_of_either_kind(traced):
    """A gap inside a program span is labelled by its name; one outside
    every program span keeps its benchmark label."""
    trace = traced.trace
    b = program_spans.breakdown(trace, program_spans.of(traced))
    labels = dict((round(s, 3), label) for label, s in b["idle_gaps"])
    assert labels[0.022] == "between calls"          # 88 ms to the next call's first kernel at 110
    assert labels[0.017] == "diffusion.sample"       # 45-62 ms: the sampler, outside every evaluation
    assert labels[0.010] == "unet_fused.table_build"  # the call's first 10 ms, midpoint inside the build
    assert {label for label, _ in b["idle_gaps"]} == {"between calls", "diffusion.sample", "unet_fused.table_build",
                                                      "host copy"}
    assert sum(b["idle_s_by_label"].values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert program_spans.breakdown(trace, None)["idle_gaps"][1] == ["sampler update", pytest.approx(0.017)]


def test_existing_readers_read_the_same_with_program_spans(traced):
    plain = run_of(synthetic()[0])
    plain._program_trace = None
    assert program_spans.of(traced) is not None
    for name in OLD:
        assert reader(name)(traced) == reader(name)(plain), name
    assert traced.trace.breakdown() == plain.trace.breakdown()
    assert all(not s[0].startswith("lds.") for s in program_spans.of(traced).spans)
    assert all(s[0].startswith("lds.") for s in traced.trace.spans)


def test_program_metrics_find_nothing_where_a_call_lacks_its_root(monkeypatch):
    trace, (program, counters) = synthetic()
    program = [s for s in program if not (s[0] == "tts.infer" and s[1] == 2)]
    monkeypatch.setattr(program_spans, "tracer", lambda: FakeTracer((program, counters)))
    run = run_of(trace)
    assert all(reader(n)(run) is None for n in NEW["flagship.solo"] | NEW["general.b32"])
    assert all(reader(n)(run_of(None)) is None for n in NEW["flagship.solo"])


def whole_run(cell, trace=True, seed=2**31 + 11):
    cname, tname = CELLS[cell]
    return run_cell(tiny.config(cname), tiny.traffic(tname), manifest.end_to_end(BENCH, cell),
                    manifest.per_layer(BENCH, cell), seed, 0.5, trace, torch.device("cpu"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_reports_the_program_metrics(cell):
    res = whole_run(cell)
    assert res["correct"] and res["failed"] == 0
    assert NEW[cell] <= set(res["metrics"])
    share = res["metrics"]["padded_frame_share" + (".b32" if cell == "general.b32" else "")]["value"]
    assert 0 < share < 100
    if cell == "flagship.solo":
        assert res["metrics"]["table_builds_per_call"]["value"] == 0.0  # the CPU runs the plain UNet: no tables
        assert res["metrics"]["prep_ms_per_call"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_without_a_program_tracer_the_run_omits_them(cell, monkeypatch):
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    res = whole_run(cell)
    assert res["correct"] and res["failed"] == 0
    assert not NEW[cell] & set(res["metrics"])
    assert set(OLD) & set(res["metrics"])
