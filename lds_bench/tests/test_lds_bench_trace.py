"""The reduction of a trace to per-layer metrics, on a synthetic trace."""

import pytest

from lds_bench import counts, manifest
from lds_bench.run import Call, Run
from lds_bench.trace import Trace, aligned, gaps, innermost, union

MS = 1_000_000


def synthetic():
    """Two calls of 2 evaluations: spans on the host, kernels on the device."""
    spans, ops = [], []
    for c, t in enumerate((0, 100 * MS)):
        spans += [("lds.call", t, t + 90 * MS), ("lds.diffusion", t + 1 * MS, t + 60 * MS),
                  ("lds.denoise", t + 5 * MS, t + 20 * MS), ("lds.denoise", t + 30 * MS, t + 45 * MS),
                  ("lds.vocoder", t + 61 * MS, t + 80 * MS), ("lds.host_copy", t + 81 * MS, t + 89 * MS)]
        ops += [("unet_fwd_kernel<bf16>", t + 10 * MS, t + 20 * MS), ("add", t + 21 * MS, t + 22 * MS),
                ("unet_fwd_kernel<bf16>", t + 35 * MS, t + 45 * MS), ("Memcpy HtoD", t + 46 * MS, t + 47 * MS),
                ("conv", t + 62 * MS, t + 80 * MS), ("Memcpy DtoH", t + 82 * MS, t + 88 * MS)]
    spans.sort(key=lambda s: s[1])
    calls = [dict(frames=448, batch=1, bucket=448, audio_s=5.0)] * 2
    return Trace(ops, spans, calls, 2)


def test_union_and_gaps():
    busy = union([("a", 0, 10), ("b", 5, 12), ("c", 20, 30)], 2, 25)
    assert busy == [(2, 12), (20, 25)]
    assert gaps(busy, 0, 40) == [(0, 2), (12, 20), (25, 40)]


def test_innermost_span():
    tr = synthetic()
    assert innermost(tr.spans, 7 * MS) == "lds.denoise"
    assert innermost(tr.spans, 25 * MS) == "lds.diffusion"
    assert innermost(tr.spans, 95 * MS) is None


def test_window_busy_and_breakdown():
    tr = synthetic()
    assert tr.window_s == pytest.approx(0.190)
    assert tr.busy_s == pytest.approx(2 * 0.046)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["unet_fwd_kernel<bf16>", pytest.approx(0.040)]
    assert b["idle_gaps"][0] == ["between calls", pytest.approx(0.022)]  # 88 ms to the next call's first kernel at 110
    assert {label for label, _ in b["idle_gaps"]} == {"denoiser step", "sampler update", "host copy", "between calls"}


def run_of(trace, device_name="NVIDIA H100 80GB HBM3"):
    cfg = manifest.config("flagship")
    cfg.update(infer_speedup=50)
    return Run(cfg, device_name, 10.0, [Call(448, 1, 448, 0.0, 0.1, 5.0)], 0.2, trace)


def reader(name):
    return manifest.metric_reader(name).read


def test_layer_metrics_from_the_trace():
    tr = synthetic()
    run = run_of(tr)
    assert reader("stage_ms.diffusion")(run) == pytest.approx(1e3 * 0.118 / 10.0)  # two spans of 59 ms
    assert reader("stage_ms.vocoder")(run) == pytest.approx(1e3 * 0.038 / 10.0)
    for name in ("stage_ms.diffusion", "stage_ms.vocoder", "launches_per_eval", "mfu", "audio_s_per_s"):
        assert reader(f"{name}.b32")(run) == reader(name)(run)  # a cell's copy reads as its base
    assert reader("idle_share.b32")(run) == reader("idle_share.solo")(run)
    assert reader("launches_per_eval")(run) == pytest.approx(6 / 4)  # a call: unet x2 and an add over 2 evaluations
    assert reader("idle_share.solo")(run) == pytest.approx(100 * (1 - 0.092 / 0.190))
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    cfg = run.cfg
    bound = counts.bound_s(counts.unet_fwd_bytes(cfg, 448), counts.unet_flops(cfg, 1, 448, time_mlp=False), peak)[0]
    assert reader("roofline.unet_fwd")(run) == pytest.approx(100 * bound * 4 / 0.040)
    flops = 2 * counts.request_flops(cfg, 1, 448)
    assert reader("mfu")(run) == pytest.approx(100 * flops / 0.190 / peak["bf16_flops"])
    assert reader("roofline.flash_attention")(run) is None  # no K5 launch in this trace


def test_readers_find_nothing_without_a_trace_or_a_known_card():
    assert all(reader(n)(run_of(None)) is None for n in ("stage_ms.vocoder", "launches_per_eval", "mfu",
                                                         "roofline.unet_fwd", "idle_share.b32"))
    assert reader("roofline.unet_fwd")(run_of(synthetic(), "some other card")) is None
    assert reader("audio_s_per_s")(run_of(None)) == pytest.approx(5.0 / 0.2)
    assert reader("latency_p95_ms")(run_of(None)) == pytest.approx(100.0)


@pytest.mark.parametrize("dropped", ["lds.diffusion", "lds.vocoder"])
def test_a_call_outside_a_stage_leaves_its_metrics_nothing_to_read(dropped):
    """One traced call without its stage span (a route round the wrapped
    layer): the stage's readers find nothing, and read no zero."""
    tr = synthetic()
    tr.spans.remove(tr.named(dropped)[1])
    run = run_of(tr)
    stage = dropped.split(".")[1]
    assert reader(f"stage_ms.{stage}")(run) is None
    if stage == "diffusion":
        assert all(reader(n)(run) is None for n in ("launches_per_eval", "roofline.unet_fwd"))
    else:
        assert reader("stage_ms.diffusion")(run) == pytest.approx(1e3 * 0.118 / 10.0)


def test_device_stamps_move_onto_the_host_clock():
    ops = [("k", 500, 600), ("marker", 100, 110)]
    assert aligned(ops, (95, 120)) == ([("k", 500, 600)], 0)  # the clocks agree: nothing moves
    assert aligned(ops, (1095, 1120)) == ([("k", 1495, 1595)], 995)
    assert aligned([], (0, 1)) == ([], 0)
