"""The general traffic generator: a traffic file's parameters -> requests.

A traffic file (`traffic/<name>.json`) fixes the batch of a call, the
lengths (a deck of quantiles of a log-normal over latent frames, clipped,
fitted to the published statistics its `source` names), the sampler and
how many answers the check compares.  The deck is dealt in
cycles, in an order the seed picks among those whose every stretch of
consecutive calls covers the distribution (`order`), so every window covers
it alike and every seed sends the same set of lengths in another order.  A
call carries `batch` utterances of one length (one length bucket, as a
serving pipeline batches them): units are rows of the seed's codebook at
uniform token ids, speakers uniform over the configuration's, and the
starting noise N(0, 1) over the padded length.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from lds_bench.reference.acoustic import bucket


@dataclass
class Request:
    """One call's inputs, on the device."""

    frames: int
    units: torch.Tensor   # (B, frames, input_channel) float32
    spk: np.ndarray       # (B,) int64, 1-based, in host memory as a caller holds it
    x_init: torch.Tensor  # (B, bucket(frames), out_dims) float32

    @property
    def batch(self) -> int:
        return self.units.shape[0]


def deck(traffic: dict) -> List[int]:
    """The lengths (latent frames) of one cycle, in quantile order: the
    `deck` quantiles at (i + 1/2) / deck of the log-normal, clipped."""
    d = traffic["lengths"]
    n = d["deck"]
    mu, sigma = math.log(d["median_frames"]), d["sigma"]
    normal = statistics.NormalDist()
    out = []
    for i in range(n):
        f = round(math.exp(mu + sigma * normal.inv_cdf((i + 0.5) / n)))
        out.append(min(max(f, d["min_frames"]), d["max_frames"]))
    return out


def _spread(n: int) -> List[int]:
    """0..n-1 in bit-reversed order: every run of consecutive entries
    spreads over the whole range (a van der Corput sequence)."""
    bits = max((n - 1).bit_length(), 1)
    return sorted(range(n), key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))


def order(traffic: dict, seed: int) -> List[int]:
    """The deck's lengths in the order this seed deals them each cycle: the
    quantiles in bit-reversed order, rotated by an offset and read forwards
    or backwards as the seed draws.  Every seed deals the same lengths, and
    any stretch of consecutive calls (the part of a cycle a window ends in)
    covers the distribution alike."""
    lengths = deck(traffic)
    n = len(lengths)
    rng = np.random.default_rng(seed)
    offset, backwards = int(rng.integers(n)), bool(rng.integers(2))
    idx = _spread(n)
    idx = idx[offset:] + idx[:offset]
    if backwards:
        idx = idx[::-1]
    return [lengths[i] for i in idx]


def requests(traffic: dict, cfg: dict, seed: int, codebook: torch.Tensor, gen: torch.Generator) -> List[Request]:
    """One request per position of the dealt deck; call i sends
    `requests[i % len(requests)]`."""
    B = traffic["batch"]
    out = []
    for frames in order(traffic, seed):
        dev = codebook.device
        ids = torch.randint(0, codebook.shape[0], (B, frames), generator=gen, device=dev)
        spk = torch.randint(1, cfg["n_spk"] + 1, (B,), generator=gen, device=dev).cpu().numpy()
        x_init = torch.randn((B, bucket(frames), cfg["out_dims"]), generator=gen, device=dev)
        out.append(Request(frames, codebook[ids], spk, x_init))
    return out
