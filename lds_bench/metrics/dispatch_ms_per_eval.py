"""Host ms of one denoiser evaluation inside the program's `denoiser.eval`
span, less the fused kernel's phase-table builds in it: the host's
dispatch of an evaluation, over the traced calls."""

from lds_bench import program_spans


def read(run):
    program = program_spans.of(run)
    return None if program is None else program.dispatch_ms_per_eval()
