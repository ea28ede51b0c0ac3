"""The comparison that decides `correct`.

After the window closes, the plain reference (`reference/acoustic.py`, float32
with TF32 off) answers a sample of the requests the window served, from the
same weights, units, speakers and starting noise, and each served waveform
is held against its answer: `wav_rel_err` is the largest relative L2 gap
||served - reference|| / ||reference|| over the sampled utterances.  The
sample holds the first call of the longest length and others drawn from
the seed.  A call that failed, or a waveform of the wrong length or with a
non-finite sample, reads infinity.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from lds_bench.reference.acoustic import canonical_weights, synthesize


def sample(frames: List[int], seed: int, n: int) -> List[int]:
    """Indices of the calls to check: the first of the longest length, then
    others drawn from the seed, `n` in all (or every call)."""
    if len(frames) <= n:
        return list(range(len(frames)))
    first_longest = frames.index(max(frames))
    rest = [i for i in range(len(frames)) if i != first_longest]
    picked = np.random.default_rng(seed + 1).choice(len(rest), size=n - 1, replace=False)
    return sorted([first_longest] + [rest[i] for i in picked])


def rel_gaps(served: np.ndarray, ref: torch.Tensor) -> List[float]:
    """||served - ref|| / ||ref|| per utterance (rows)."""
    if served is None or tuple(served.shape) != tuple(ref.shape):
        return [math.inf] * ref.shape[0]
    got = torch.as_tensor(served, device=ref.device, dtype=torch.float32)
    if not bool(torch.isfinite(got).all()):
        return [math.inf] * ref.shape[0]
    num = (got - ref).norm(dim=-1)
    den = ref.norm(dim=-1).clamp_min(1e-30)
    return (num / den).tolist()


def reference_weights(u2m_weights, voc_weights, cfg: dict):
    """The drawn weights as the reference reads them: float32, the Unit2Mel
    leaves under canonical names."""
    return canonical_weights(u2m_weights, cfg), {k: v.float() for k, v in voc_weights.items()}


@torch.no_grad()
def reference_answers(W, V, cfg: dict, request, precision: str = "f32", rows: int = 8):
    """The reference's waveform for one request, in blocks of `rows`
    utterances so that it fits beside what is still allocated."""
    out = []
    for lo in range(0, request.batch, rows):
        sl = slice(lo, lo + rows)
        spk = torch.as_tensor(request.spk[sl], device=request.units.device)
        out.append(synthesize(W, V, request.units[sl], spk, request.x_init[sl], cfg, precision))
    return torch.cat(out)


def compare(u2m_weights, voc_weights, cfg: dict, checked) -> Dict[str, float]:
    """checked: (request, served waveform) pairs -> the numbers compared."""
    W, V = reference_weights(u2m_weights, voc_weights, cfg)
    worst = 0.0
    for request, served in checked:
        ref = reference_answers(W, V, cfg, request)
        worst = max([worst] + rel_gaps(served, ref))
    return {"wav_rel_err": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
