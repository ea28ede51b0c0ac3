"""K4 forward: self-attention for the UNet's transformer blocks.

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/fused_attention.py`
(forward).  `fused_attention` launches the CUDA kernel in
`csrc/attention_fwd.cu` for CUDA tensors and runs `fused_attention_plain`
for CPU tensors; there is no other path.  Unlike the TPU kernel it takes any
T (K/V stream through shared memory), so no length cap and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

__all__ = [
    "fused_attention",
    "fused_attention_with_lse",
    "fused_attention_plain",
    "SUPPORTED_HEAD_DIMS",
]

SUPPORTED_HEAD_DIMS = (32, 48, 64)
_DTYPES = {torch.bfloat16: "attention_fwd_bf16", torch.float32: "attention_fwd_f32"}

# kernel launches since the last reset (chip_smoke.py resets and reads it)
launches = 0


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, D) self-attention -> (out (B, T, H, D), lse (B*H, T) f32).

    f32 scores and softmax; p rounded to the input dtype before p @ v, which
    accumulates in f32 and rounds to the input dtype (the TPU kernel's
    numerics)."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, T)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"self-attention over (B, T, H, D) only: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention takes bf16 or f32, got {q.dtype} {k.dtype} {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError("q, k, v on different devices")
        if x.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")


def fused_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As `fused_attention`, also returning the f32 lse rows (B*H, T)."""
    global launches
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention: no kernel for device {q.device}")
    _check(q, k, v)
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import load_library

    B, T, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = getattr(load_library(), _DTYPES[q.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, T, H, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    launches += 1
    return out, lse


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Self-attention over (B, T, H, D): the kernel on CUDA, the plain
    version on CPU."""
    return fused_attention_with_lse(q, k, v, scale)[0]
