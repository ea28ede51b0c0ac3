"""% of the denoiser evaluations of the traced calls that replayed a CUDA
graph: the program's `denoiser.graph_replays` counter over its
`denoiser.eval` spans.  Nothing where the program counts no evaluation by
its graph route (a program without denoiser graphs) or where an evaluation
lacks its span."""

from lds_bench import program_spans

ROUTES = ("denoiser.graph_replays", "denoiser.graph_captures", "denoiser.graph_warmups", "denoiser.graph_bypasses")


def read(run):
    program = program_spans.of(run)
    if program is None or not any(k in program.counters for k in ROUTES):
        return None
    evals = len(program.named("denoiser.eval"))
    if evals == 0 or evals != program.evals:
        return None
    return 100.0 * program.counters.get("denoiser.graph_replays", 0) / evals
