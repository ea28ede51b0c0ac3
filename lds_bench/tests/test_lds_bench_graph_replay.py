"""`graph_replay_share` and `graph_replay_share.b32`: the share of the
traced calls' denoiser evaluations that replayed a CUDA graph, read from
the program's counters, on the synthetic trace of
`test_lds_bench_program_spans.py` (two calls of two evaluations) and in
whole traced runs at tiny widths on the CPU, where no graph engages."""

import pytest

from lds_bench import program_spans
from lds_bench.tests.test_lds_bench_program_spans import FakeTracer, reader, run_of, synthetic, whole_run

NAMES = ("graph_replay_share", "graph_replay_share.b32")


def traced_with(monkeypatch, extra=None, drop_eval=False):
    trace, (program, counters) = synthetic()
    if drop_eval:
        program = program[:3] + program[4:]  # the first call's first `denoiser.eval`
    monkeypatch.setattr(program_spans, "tracer", lambda: FakeTracer((program, {**counters, **(extra or {})})))
    return run_of(trace)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counters,share", [
    ({"denoiser.graph_replays": 3, "denoiser.graph_captures": 1}, 75.0),
    ({"denoiser.graph_replays": 4}, 100.0),
    ({"denoiser.graph_bypasses": 4}, 0.0),
    ({"denoiser.graph_warmups": 1, "denoiser.graph_captures": 1, "denoiser.graph_replays": 2}, 50.0),
])
def test_replays_over_the_evaluation_spans(monkeypatch, name, counters, share):
    assert reader(name)(traced_with(monkeypatch, counters)) == pytest.approx(share)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_graph_counters_a_tracer_or_every_evaluation(monkeypatch, name):
    """A program that counts no graph route (the parent's), a run with no
    program tracer, and a trace that lost an evaluation's span read nothing."""
    assert reader(name)(traced_with(monkeypatch)) is None
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    assert reader(name)(run_of(synthetic()[0])) is None
    assert reader(name)(run_of(None)) is None
    assert reader(name)(traced_with(monkeypatch, {"denoiser.graph_replays": 3}, drop_eval=True)) is None


@pytest.mark.parametrize("cell,name", [("flagship.solo", "graph_replay_share"),
                                       ("general.b32", "graph_replay_share.b32")])
def test_a_traced_cpu_run_reads_no_replay(cell, name):
    res = whole_run(cell)
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"][name] == {"value": 0.0, "unit": "%"}
