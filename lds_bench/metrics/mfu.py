"""The model step's share of the card's bf16 peak, in %: the operations the
traced calls need at their own lengths (condition, every denoiser
evaluation, vocoder; counted from the shapes, `counts.request_flops`) over
the traced window's seconds and the published peak."""

from lds_bench import counts


def read(run):
    if run.trace is None:
        return None
    peak = counts.peaks(run.device_name)
    if peak is None or run.trace.window_s <= 0:
        return None
    flops = sum(counts.request_flops(run.cfg, c["batch"], c["frames"]) for c in run.trace.calls)
    return 100.0 * flops / run.trace.window_s / peak["bf16_flops"]
