"""The flash-attention kernel (K5) against its roofline, in %: the least
time of every self-attention call the traced calls' denoiser evaluations
make (q, k, v read and the output written once, 4 x head dim operations
per query-key pair and head, at the card's published peaks), over the
device time of the K5 launches inside their diffusion spans."""

from lds_bench import counts


def read(run):
    if run.trace is None:
        return None
    peak = counts.peaks(run.device_name)
    if peak is None:
        return None
    least = spent = 0.0
    for call, ops in run.trace.per_call("diffusion"):
        launches = [(s, e) for name, s, e in ops if "flash_attention" in name]
        if not launches:
            continue
        shapes = counts.attention_calls(run.cfg, call["batch"], call["bucket"])
        least += run.trace.evals_per_call * counts.attention_bound_s(shapes, run.cfg["dtype"], peak)
        spent += sum(e - s for s, e in launches) / 1e9
    return 100.0 * least / spent if spent else None
