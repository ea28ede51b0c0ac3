"""Weights and inputs drawn from the run's seed, on the device, in bulk.

One `torch.randn` call draws every leaf of a module at once; each leaf is
then a scaled slice of it, in the type it is served in (products and their
biases in the configuration's dtype, norms and embeddings in float32).
Products are LeCun-normal (std 1 / sqrt(fan-in)); a transposed
convolution's fan-in is its input channels times kernel / stride, which is
2 x its input channels in HiFi-GAN's geometry (kernel = 2 x stride).  Biases
and norm offsets draw N(0, 0.02^2) and N(0, 0.1^2), norm scales 1 + N(0,
0.1^2), embeddings N(0, 1 / width): no leaf is a constant, so every one of
them reaches the answer.

A random denoiser predicts noise unrelated to its input, so the sampler
ends ~1 / alpha(T) (~157 with the linear betas to 0.02) times the scale of
its unit-variance start, where a trained one ends near the unit scale of
the codec's latents.  `scale_vocoder_input` takes that factor out of the
vocoder's first convolution, so that the waveform lies in tanh's linear
range (at the shipped widths: std ~0.2, no sample beyond 0.99) rather than
saturated at +-1, where it would hide the differences the check reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, tuple, str]]


def draw(spec: Spec, gen: torch.Generator, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every (name, shape, kind) of `spec`."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind == "w":
            out[name] = (v * math.prod(shape[1:]) ** -0.5).to(dtype)
        elif kind == "wt":
            out[name] = (v * (2 * shape[0]) ** -0.5).to(dtype)
        elif kind == "b":
            out[name] = (v * 0.02).to(dtype)
        elif kind == "norm_w":
            out[name] = 1.0 + 0.1 * v
        elif kind == "norm_b":
            out[name] = 0.1 * v
        elif kind == "emb":
            out[name] = v * shape[-1] ** -0.5
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    return out


def scale_vocoder_input(voc: Dict[str, torch.Tensor], cfg: dict) -> None:
    """Multiply the vocoder's first convolution by alpha(T) = sqrt(prod(1 -
    beta)) over the configuration's linear betas (in place)."""
    betas = torch.linspace(cfg["beta_start"], cfg["beta_end"], cfg["timesteps"], dtype=torch.float64)
    alpha_T = float(torch.prod(1.0 - betas).sqrt())
    w = voc["conv_pre.weight"]
    voc["conv_pre.weight"] = (w.float() * alpha_T).to(w.dtype)


def codebook(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """The semantic codebook (codebook_size, input_channel), N(0, 1) float32:
    the units a request carries are its rows."""
    return torch.randn((cfg["codebook_size"], cfg["input_channel"]), generator=gen, device=device)
