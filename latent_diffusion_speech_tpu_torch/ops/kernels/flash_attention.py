"""K5: tiled online-softmax attention (FlashAttention-2 recurrence).

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/flash_attention.py`.
`flash_attention` launches a kernel of `csrc/flash_attention.cu` for CUDA
tensors and runs `flash_attention_plain` for CPU tensors; any other device
raises.  The dtype picks the kernel (`ENTRIES`): bf16 runs on the tensor
cores (`flash_attention_bf16`), f32 on the CUDA cores
(`flash_attention_f32`).  With `bias` or `mask` it runs the port's plain
`ops/attention.py::dot_product_attention`, as the JAX function does (its
kernel takes neither); those calls count in `plain_routes`, not in
`launches`.

Its numerics are the TPU kernel's, not K4's: f32 scores, the softmax
probabilities kept at f32 accuracy for p @ v (the bf16 kernel splits p into
two bf16 parts and runs both through the MMA; K4 and the plain attention
round p to the input dtype first), and the output acc / max(l, 1e-30) cast
to the input dtype.  `is_causal` keeps key col <= query row aligned
top-left, as the kernel does; `dot_product_attention` aligns bottom-right
(`tril(Tkv - Tq)`), so the two differ when Tq != Tkv.

The bf16 kernel copies q, k and v in 16-byte pieces: their data pointers
and (b, t, h) strides must be 16-byte aligned, or the call raises
ValueError.  `plan` makes every check and picks the entry without touching
the device (the checks K4 shares sit in `build.attention_plan`);
`launch_args` packs a launch's arguments into the struct the C entries take
(`ARGS`, field by field as `ARG_NAMES` names them).  `flash_attention_simt`
runs the CUDA-core kernel in bf16, a yardstick for `chip_smoke.py`; no serve
or training path calls it.

The TPU kernel has no backward, so neither has this one: a call that would
need a gradient raises.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from latent_diffusion_speech_tpu_torch.ops.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_simt", "plan", "launch_args",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = build.HEAD_DIMS
ENTRIES = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
SIMT_BF16 = "flash_attention_simt_bf16"
# the C entries' one argument: the struct `Args` of csrc/flash_attention.cu,
# its fields in order (the C side asserts each field's offset)
ARG_NAMES = ("q", "k", "v", "out", "stream", "sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh",
             "B", "Tq", "Tkv", "H", "D", "causal", "scale")
ARGS = struct.Struct("<5q9q6if4x")

# kernel launches, and calls routed to the plain attention by a bias or a
# mask, since the last reset (chip_smoke.py resets and reads them)
launches = 0
plain_routes = 0
build.counts_launches(__name__, "launches", "plain_routes")


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


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[str, tuple]:
    """Check q, k, v for the kernels and return (entry name, the nine
    (b, t, h) strides of q, k, v in elements).  Reads no device data, so it
    runs on tensors of any device."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or ks != v.shape or len(ks) != 4 or qs[0] != ks[0] or qs[2] != ks[2] or qs[3] != ks[3]:
        raise ValueError(f"flash_attention takes q (B, Tq, H, D) and k, v (B, Tkv, H, D): {qs} {ks} {v.shape}")
    if qs[1] == 0 or ks[1] == 0:
        raise ValueError(f"flash_attention: empty sequence, Tq={qs[1]} Tkv={ks[1]}")
    if qs[0] * qs[2] > 65535:
        raise ValueError(f"flash_attention: B * H = {qs[0] * qs[2]} over the grid's 65535")
    return build.attention_plan("flash_attention", q, k, v, ENTRIES)


def launch_args(q, k, v, out, strides: tuple, is_causal: bool, scale: Optional[float], stream: int) -> bytes:
    """One launch's arguments packed as `ARGS`, in the order of `ARG_NAMES`
    (runs on tensors of any device)."""
    B, Tq, H, D = q.shape
    return ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stream, *strides,
                     B, Tq, k.shape[1], H, D, is_causal, D**-0.5 if scale is None else scale)


def _launch(name: str, q, k, v, strides: tuple, is_causal: bool, scale: Optional[float]) -> torch.Tensor:
    out = q.new_empty(q.shape)
    build.launch_packed(name, q.get_device(),
                        lambda stream: launch_args(q, k, v, out, strides, is_causal, scale, stream))
    return out


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
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, is_causal, scale)
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    name, strides = plan(q, k, v)
    out = _launch(name, q, k, v, strides, bool(is_causal), scale)
    launches += 1
    return out


def flash_attention_simt(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool = False, scale: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA-core kernel in bf16 on CUDA tensors, the same function as
    `flash_attention`: a same-call yardstick for the tensor-core kernel.
    Not counted in `launches`."""
    if q.dtype != torch.bfloat16 or not q.is_cuda:
        raise ValueError(f"flash_attention_simt takes bf16 CUDA tensors, got {q.dtype} on {q.device}")
    _, strides = plan(q, k, v)
    return _launch(SIMT_BF16, q, k, v, strides, bool(is_causal), scale)
