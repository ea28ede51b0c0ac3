"""95th percentile (nearest rank) of every call's latency in the window, in
ms: from the call's start to its waveform in host memory.  A failed call
counts as missing any limit: it reads infinitely late."""

import math


def read(run):
    lat = sorted(c.latency_s if c.error is None else math.inf for c in run.calls)
    value = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
    return value if math.isfinite(value) else None
