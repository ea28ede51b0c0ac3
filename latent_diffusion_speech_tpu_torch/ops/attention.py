"""Shared multi-head attention op (plain PyTorch).

Counterpart of `latent_diffusion_speech_tpu/ops/attention.py`: attention
over (B, T, H, D) tensors with an f32 softmax whatever the input dtype, the
probabilities cast back to the input dtype before the product with v.  The
UNet's self-attention goes through the K4 kernel wrapper instead
(`ops/kernels/fused_attention.py`); everything else (RoFormer encoder and
decode loop) uses this function.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dot_product_attention", "rotate_half", "apply_rotary"]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Tq, H, D), k/v (B, Tkv, H, D) -> (B, Tq, H, D).

    mask: broadcastable bool (True = attend) of shape (..., Tq, Tkv);
    bias: additive float bias with the same broadcast rules."""
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
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 2d) -> rotate pairs, HF RoFormer convention (interleaved)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding with sin/cos (T, D), values repeated pairwise."""
    return x * cos + rotate_half(x) * sin
