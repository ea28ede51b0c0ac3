"""Symmetric per-output-channel int8 weight quantization for serving.

Counterpart of `latent_diffusion_speech_tpu/ops/weight_quant.py`, with the
same rule: every float parameter with ndim >= 2 and at least `min_size`
elements becomes int8 values with one bf16 scale per output channel,
`scale = max(amax, 1e-8) / 127` over the channel's elements in f32,
`q = clip(round(w / scale), -127, 127)` (round half to even, as
`jnp.round`); smaller leaves (norm scales, biases) pass through.  The
output channel is the last axis of a flax kernel and the FIRST of a torch
weight (a `Linear`'s (out, in), a convolution's (out, in, k)), so the
amax runs over every dimension but the first; the int8 values equal JAX's
on the same parameters.

The JAX package dequantizes inside the sampler's scan, where XLA fuses the
convert and the scale into the consuming matmul; it measured int8 3.5%
slower than bf16 on its chip at the flagship B=1 serve shape (an
overhead-bound step).  Here `models/diffusion/unit2mel.py` quantizes the
UNet once per serve call and dequantizes to the compute dtype before each
denoiser call (`dequantize_tree`, one multiply a weight), so the denoiser
runs on the dequantized weights; the card's time is recorded in PERF.md.
Serving only, opt-in (`Unit2MelSystem(weight_quant="int8")`, the config's
`common.infer.weight_quant`); training sees the full-precision weights.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

__all__ = ["QuantizedLeaf", "quantize_tree_int8", "dequantize_tree", "tree_bytes"]


class QuantizedLeaf(NamedTuple):
    """int8 values and a bf16 scale per output channel (dim 0), shaped to
    broadcast against them: (out, 1, ...)."""

    q: torch.Tensor
    scale: torch.Tensor


def _is_quantizable(x, min_size: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 2 and x.numel() >= min_size and x.is_floating_point()


@torch.no_grad()
def quantize_int8(x: torch.Tensor) -> QuantizedLeaf:
    xf = x.detach().float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedLeaf(q, scale.to(torch.bfloat16))


def quantize_tree_int8(params: Dict[str, torch.Tensor], min_size: int = 4096) -> Dict[str, object]:
    """Every quantizable leaf of `params` ({name: tensor}) as a
    `QuantizedLeaf`; the others as they are."""
    return {k: quantize_int8(v) if _is_quantizable(v, min_size) else v for k, v in params.items()}


def dequantize_tree(qparams: Dict[str, object], dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Inverse of `quantize_tree_int8`: q in `dtype` times the scale in
    `dtype` (JAX's `q.astype(dtype) * scale.astype(dtype)`); other leaves
    as they are."""
    return {k: v.q.to(dtype) * v.scale.to(dtype) if isinstance(v, QuantizedLeaf) else v for k, v in qparams.items()}


def tree_bytes(tree: Dict[str, object]) -> int:
    """The bytes a tree's tensors hold (a `QuantizedLeaf` its values and scales)."""
    total = 0
    for v in tree.values():
        for t in (v if isinstance(v, QuantizedLeaf) else (v,)):
            total += t.numel() * t.element_size()
    return total
