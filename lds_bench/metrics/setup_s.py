"""Seconds from the process's start to the first timed call: imports, the
program's kernel library (built on a checkout's first run, loaded after),
weights and requests drawn from the seed, the pipeline built, and one call
of every shape the cell sends."""


def read(run):
    return run.setup_s
