"""Shared multi-head attention op (plain PyTorch).

Counterpart of `latent_diffusion_speech_tpu/ops/attention.py`: attention
over (B, T, H, D) tensors with an f32 softmax whatever the input dtype, the
probabilities cast back to the input dtype before the product with v.

`impl` routes a call as the JAX function does: 'xla' (the default) is the
plain path below; 'pallas' is the K5 kernel wrapper
(`ops/kernels/flash_attention.py`, which itself takes the plain path for a
bias or a mask); 'fused' is the K4 wrapper (`ops/kernels/fused_attention.py`)
for self-attention with no bias, mask or causal mask and T <= 512, and the
plain path otherwise.  The flagship UNet calls the K4 wrapper directly for
'xla' and 'fused' (`models/diffusion/unet1d.py`); the RoFormer (its training
forward, encoder and decode loop) uses the plain path.

Dropout on the attention probabilities (HF attention_probs_dropout) runs on
the plain path only, when `dropout_rate > 0` and a `torch.Generator` is
given: keep ~ Bernoulli(1 - p) over the probabilities (already in the input
dtype), kept ones divided by (1 - p).  The K4 route refuses such a call (it
takes the plain path) as the JAX function does; K5 has no dropout and
raises.  Ring attention (sequence parallelism) is not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from latent_diffusion_speech_tpu_torch.ops.kernels.flash_attention import flash_attention
from latent_diffusion_speech_tpu_torch.ops.kernels.fused_attention import fused_attention
from latent_diffusion_speech_tpu_torch.parallel import mesh as rows

__all__ = ["dot_product_attention", "dropout", "rotate_half", "apply_rotary", "MAX_FUSED_T"]

MAX_FUSED_T = 512  # the JAX package's cap on the single-block K4 route


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "xla",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_split: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """q (B, Tq, H, D), k/v (B, Tkv, H, D) -> (B, Tq, H, D).

    mask: broadcastable bool (True = attend) of shape (..., Tq, Tkv);
    bias: additive float bias with the same broadcast rules;
    impl: 'xla' | 'pallas' (K5) | 'fused' (K4 where eligible);
    dropout_rate, generator: dropout on the probabilities, drawn from
    `generator` (on q's device); off when either is unset;
    dropout_split: (dim, index, size) when the probabilities (B, H, Tq, Tk)
    are chunk `index` of `size` along `dim` (a rank's heads under tensor
    parallelism): the mask is drawn whole and cut (`dropout`)."""
    dropping = dropout_rate > 0.0 and generator is not None
    if impl == "pallas":
        if dropping:
            raise ValueError("impl='pallas' (K5) has no attention dropout; use impl='xla'")
        return flash_attention(q, k, v, bias=bias, mask=mask, is_causal=is_causal, scale=scale)
    if impl == "fused":
        if (bias is None and mask is None and not is_causal and not dropping
                and q.shape == k.shape == v.shape and q.shape[1] <= MAX_FUSED_T):
            return fused_attention(q, k, v, scale)
    elif impl != "xla":
        raise ValueError(f"impl must be 'xla', 'pallas' or 'fused', got {impl!r}")
    orig_dtype = q.dtype
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # f32 products of the input-dtype values == f32 accumulation
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    neg = torch.finfo(torch.float32).min
    if is_causal:
        t_q, t_kv = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((t_q, t_kv), dtype=torch.bool, device=q.device).tril(t_kv - t_q)
        logits = logits.masked_fill(~causal, neg)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)
    weights = torch.softmax(logits, dim=-1).to(orig_dtype)
    weights = dropout(weights, dropout_rate, generator, dropout_split)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax nn.Dropout: keep ~ Bernoulli(1 - rate), kept values divided by
    (1 - rate); the identity without a generator or at rate 0.  A
    `parallel.mesh.RowGenerator` draws the mask for the global batch (x's
    leading dimension is the batch) and keeps this rank's rows.  split:
    (dim, index, size) when x is chunk `index` of `size` along `dim`: the
    mask is drawn for the whole tensor and cut the same way, so the ranks
    together draw what one process draws."""
    if generator is None or rate <= 0.0:
        return x
    if split is None:
        u = rows.rand(x.shape, generator, device=x.device)
    else:
        dim, index, size = split
        whole = list(x.shape)
        whole[dim] *= size
        u = rows.rand(whole, generator, device=x.device).narrow(dim, index * x.shape[dim], x.shape[dim])
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 2d) -> rotate pairs, HF RoFormer convention (interleaved)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding with sin/cos (T, D), values repeated pairwise."""
    return x * cos + rotate_half(x) * sin
