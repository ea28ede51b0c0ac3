"""The program's `unet_fused.table_builds` counter (phase tables the fused
UNet kernel built, cache misses) over the traced calls."""

from lds_bench import program_spans


def read(run):
    program = program_spans.of(run)
    return None if program is None else program.table_builds_per_call()
