"""K5: tiled online-softmax attention (FlashAttention-2 recurrence).

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/flash_attention.py`.
`flash_attention` launches the kernel in `csrc/flash_attention.cu` for CUDA
tensors and runs `flash_attention_plain` for CPU tensors; any other device
raises.  With `bias` or `mask` it runs the port's plain
`ops/attention.py::dot_product_attention`, as the JAX function does (its
kernel takes neither); those calls count in `plain_routes`, not in
`launches`.

Its numerics are the TPU kernel's, not K4's: q is scaled in f32 before q.k,
the softmax probabilities stay f32 for p @ v (K4 and the plain attention
round them to the input dtype first), and the output is acc / max(l, 1e-30)
cast to the input dtype.  `is_causal` keeps key col <= query row aligned
top-left, as the kernel does; `dot_product_attention` aligns bottom-right
(`tril(Tkv - Tq)`), so the two differ when Tq != Tkv.

The TPU kernel has no backward, so neither has this one: a call that would
need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_plain", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (32, 48, 64)
_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}

# kernel launches, and calls routed to the plain attention by a bias or a
# mask, since the last reset (chip_smoke.py resets and reads them)
launches = 0
plain_routes = 0

_fns: dict = {}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, Tq, H, D) x (B, Tkv, H, D) -> (B, Tq, H, D) with the kernel's
    numerics: f32 scores of the f32-scaled q, top-left causal mask, f32
    probabilities times f32 v, output cast to q's dtype."""
    Tq, Tkv, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = scale if scale is not None else D**-0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if is_causal:
        keep = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (q.shape[0], q.shape[2:]) != (k.shape[0], k.shape[2:]):
        raise ValueError(f"flash_attention takes q (B, Tq, H, D) and k, v (B, Tkv, H, D): {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes bf16 or f32, got {q.dtype} {k.dtype} {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention: empty sequence, Tq={q.shape[1]} Tkv={k.shape[1]}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"flash_attention: B * H = {q.shape[0] * q.shape[2]} over the grid's 65535")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError("q, k, v on different devices")
        if x.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")


def _entry(dtype: torch.dtype):
    """The kernel's ctypes function, its argument types set once per library."""
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    fn = _fns.get((id(lib), dtype))
    if fn is None:
        fn = getattr(lib, _ENTRY[dtype])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _fns[(id(lib), dtype)] = fn
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over q (B, Tq, H, D) and k, v (B, Tkv, H, D): the kernel on
    CUDA, the plain version on CPU, the plain `dot_product_attention` when
    `bias` or `mask` is given.  Returns (B, Tq, H, D) in q's dtype."""
    global launches, plain_routes
    if bias is not None or mask is not None:
        from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention

        plain_routes += 1
        return dot_product_attention(q, k, v, bias=bias, mask=mask, is_causal=is_causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention (K5) has no backward, as the TPU kernel has none: "
            "train with attn_impl='xla' or 'fused'"
        )
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, is_causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    B, Tq, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, k.shape[1], H, D,
                 ctypes.addressof(strides), float(scale), int(bool(is_causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return out
