"""Device kernels (copies and fills left out) that start inside the traced
calls' diffusion spans, over their denoiser evaluations."""

from lds_bench.trace import is_kernel


def read(run):
    if run.trace is None:
        return None
    per_call = run.trace.per_call("diffusion")
    kernels = sum(1 for _, ops in per_call for name, _, _ in ops if is_kernel(name))
    evals = run.trace.evals_per_call * len(per_call)
    return kernels / evals if evals and kernels else None
