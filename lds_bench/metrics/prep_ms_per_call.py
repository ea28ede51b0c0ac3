"""Host ms a traced call spends in the program's `diffusion.prepare` span
(the weights packed or quantised for the sampler) and its
`unet_fused.table_build` spans (the fused kernel's phase tables)."""

from lds_bench import program_spans


def read(run):
    program = program_spans.of(run)
    return None if program is None else program.prep_ms_per_call()
