"""The share of the traced window, in %, in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct
