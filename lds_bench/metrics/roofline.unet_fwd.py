"""The fused whole-UNet kernel (K2/K3, `unet_fwd_kernel`) against its
roofline, in %: the least time of each launch at its launched frame count
(the benchmark's operation and byte count, `counts.py`, at the card's
published peaks) summed over the traced launches, over their summed device
time.  Nothing to read on a card without published peaks or where the
kernel did not run."""

from lds_bench import counts


def read(run):
    if run.trace is None:
        return None
    peak = counts.peaks(run.device_name)
    if peak is None:
        return None
    least = spent = 0.0
    for call, ops in run.trace.per_call("diffusion"):
        launches = [(s, e) for name, s, e in ops if "unet_fwd_kernel" in name]
        T = call["bucket"]
        bound, _ = counts.bound_s(counts.unet_fwd_bytes(run.cfg, T),
                                  counts.unet_flops(run.cfg, 1, T, time_mlp=False), peak)
        least += bound * len(launches)
        spent += sum(e - s for s, e in launches) / 1e9
    return 100.0 * least / spent if spent else None
