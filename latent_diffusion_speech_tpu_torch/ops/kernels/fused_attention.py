"""K4: self-attention for the UNet's transformer blocks, forward and backward.

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/fused_attention.py`.
`fused_attention_with_lse` launches a forward kernel of
`csrc/attention_fwd.cu` and `attention_bwd` the backward kernel in
`csrc/attention_bwd.cu` for CUDA tensors; for CPU tensors they run
`fused_attention_plain` and `fused_attention_bwd_plain`.  There is no other
path.  The dtype picks the forward kernel (`ENTRIES`): bf16 runs on the
tensor cores (`attention_fwd_bf16`), f32 on the CUDA cores
(`attention_fwd_f32`).  Unlike the TPU kernels they take any T (tiles
stream through shared memory), so no length cap and no fallback.

The bf16 forward copies q, k and v in 16-byte pieces: their data pointers
and (b, t, h) strides must be 16-byte aligned, or the call raises
ValueError.  `plan` makes every check and picks the entry without touching
the device (the checks K5 shares sit in `build.attention_plan`);
`launch_args` packs a launch's arguments into the struct the C entries take
(`ARGS`, field by field as `ARG_NAMES` names them).  `attention_fwd_simt`
runs the CUDA-core forward in bf16, a yardstick for `chip_smoke.py`; no serve
or training path calls it.

The backward launches as `bwd_plan` lays it out (a block per head and key
tile, four heads a block where T <= 16) with one packed struct (`BWD_ARGS`,
`BWD_ARG_NAMES`); its dq sums run in a fixed order, so two calls on the
same inputs give bit-identical gradients.  Where a head has several key
tiles, an int32 counter tells the last of its blocks to finish, which
merges dq and resets the counter.  The counters are one buffer per device, shared by every
call on it, so backward calls on one device must not run concurrently (on
two streams, or a CUDA graph replayed beside an eager call): the trainer
runs them on one stream.

`fused_attention` is what the UNet calls: when a gradient is needed it goes
through `FusedAttention`, the counterpart of the JAX `custom_vjp`, which
saves (q, k, v, out, lse) and runs the backward kernel; otherwise (serving,
`torch.no_grad()`) it launches the forward kernel alone, saving nothing.
The forward takes head dims 8, 32, 48 and 64 (`SUPPORTED_HEAD_DIMS`), the
backward 32, 48 and 64 (`BWD_HEAD_DIMS`): on CUDA tensors a call that
needs a gradient at head dim 8 raises ValueError before the forward runs
(ROADMAP.md Queue 2).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from latent_diffusion_speech_tpu_torch.ops.kernels import build

__all__ = [
    "bwd_plan",
    "bwd_blocks",
    "fused_attention",
    "fused_attention_with_lse",
    "fused_attention_plain",
    "attention_fwd_simt",
    "attention_bwd",
    "fused_attention_bwd_plain",
    "FusedAttention",
    "plan",
    "launch_args",
    "SUPPORTED_HEAD_DIMS",
    "BWD_HEAD_DIMS",
]

SUPPORTED_HEAD_DIMS = build.HEAD_DIMS
BWD_HEAD_DIMS = build.BWD_HEAD_DIMS
ENTRIES = {torch.bfloat16: "attention_fwd_bf16", torch.float32: "attention_fwd_f32"}
SIMT_BF16 = "attention_fwd_simt_bf16"
_BWD = {torch.bfloat16: "attention_bwd_bf16", torch.float32: "attention_bwd_f32"}
# the forward entries' one argument: the struct `Args` of csrc/attention_fwd.cu,
# its fields in order (the C side asserts each field's offset)
ARG_NAMES = ("q", "k", "v", "out", "lse", "stream", "sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh",
             "B", "T", "H", "D", "scale")
ARGS = struct.Struct("<6q9q4if4x")
# the backward entries' one argument: the struct `BwdArgs` of
# csrc/attention_bwd.cu, its fields in order (the C side asserts each offset)
_STRIDES = tuple(f"s{x}{a}" for x in ("q", "k", "v", "o", "do") for a in "bth")
BWD_ARG_NAMES = ("q", "k", "v", "o", "dout", "lse", "dq", "dk", "dv", "dq_part", "counters", "stream", *_STRIDES,
                 "B", "T", "H", "D", "tile", "vec", "scale")
BWD_ARGS = struct.Struct("<12q15q6if4x")
_counters: dict = {}  # device index -> int32 zeros the backward's dq merge counts with (reset by the kernel)

# kernel launches since the last reset (chip_smoke.py resets and reads them)
launches = 0
bwd_launches = 0


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


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"self-attention over (B, T, H, D) only: {q.shape} {k.shape} {v.shape}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[str, tuple]:
    """Check q, k, v for the forward kernels and return (entry name, the
    nine (b, t, h) strides of q, k, v in elements).  Reads no device data,
    so it runs on tensors of any device."""
    _check_shapes(q, k, v)
    return build.attention_plan("fused_attention", q, k, v, ENTRIES)


def launch_args(q, k, v, out, lse, strides: tuple, scale: Optional[float], stream: int) -> bytes:
    """One forward launch's arguments packed as `ARGS`, in the order of
    `ARG_NAMES` (runs on tensors of any device)."""
    B, T, H, D = q.shape
    return ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), stream, *strides,
                     B, T, H, D, D**-0.5 if scale is None else scale)


def _launch(name: str, q, k, v, strides: tuple, scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, _ = q.shape
    out = q.new_empty(q.shape)
    lse = q.new_empty((B * H, T), dtype=torch.float32)
    build.launch_packed(name, q.get_device(), lambda stream: launch_args(q, k, v, out, lse, strides, scale, stream))
    return out, lse


def fused_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As `fused_attention`, also returning the f32 lse rows (B*H, T)."""
    global launches
    if not q.is_cuda:
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v, scale)
        raise RuntimeError(f"fused_attention: no kernel for device {q.device}")
    name, strides = plan(q, k, v)
    out_lse = _launch(name, q, k, v, strides, scale)
    launches += 1
    return out_lse


def attention_fwd_simt(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core forward in bf16 on CUDA tensors, the same function
    as `fused_attention_with_lse`: a same-call yardstick for the
    tensor-core kernel.  Not counted in `launches`."""
    if q.dtype != torch.bfloat16 or not q.is_cuda:
        raise ValueError(f"attention_fwd_simt takes bf16 CUDA tensors, got {q.dtype} on {q.device}")
    _, strides = plan(q, k, v)
    return _launch(SIMT_BF16, q, k, v, strides, scale)


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of self-attention from the forward's (out, lse (B*H, T)).

    The TPU backward's numerics: p = exp(s - lse) in f32, rounded to the
    input dtype before p^T do; ds = p * (do v^T - rowsum(do * out)) * scale
    rounded to the input dtype before ds k and ds^T q; f32 accumulation."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else D**-0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof).to(q.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(q.dtype)
    return dq, dk, dv


def bwd_plan(B: int, T: int, H: int, D: int, tile: Optional[int] = None) -> dict:
    """The backward kernel's launch plan: key tiles of `tile` keys (by
    default 16 where T <= 16, else 32; tile=32 at T <= 16 is the yardstick
    `chip_smoke.py` times the 16-key path against), `heads` heads a block of
    128 threads (4 with 16-key tiles, a warp each), grid (n_kt, head
    groups), and the f32 dq partial scratch and int32 counters it needs when
    a head has several key tiles."""
    if tile is None:
        tile = 16 if T <= 16 else 32
    if tile not in (16, 32) or (tile == 16 and T > 16):
        raise ValueError(f"bwd_plan: {tile}-key tiles at T={T}")
    heads = 4 if tile == 16 else 1
    n_kt = -(-T // tile)
    several = n_kt > 1
    return dict(tile=tile, heads=heads, n_kt=n_kt, grid=(n_kt, -(-(B * H) // heads)),
                dq_part=B * H * n_kt * T * D if several else 0, counters=B * H if several else 0)


def bwd_blocks(plan: dict, B: int, H: int):
    """For each block (x, y) of `plan`'s grid, the (batch * head, key tile)
    pairs it computes (as csrc/attention_bwd.cu assigns them)."""
    nx, ny = plan["grid"]
    for y in range(ny):
        for x in range(nx):
            yield (x, y), [(y * plan["heads"] + g, x) for g in range(plan["heads"]) if y * plan["heads"] + g < B * H]


def _vec_ok(dtype, pointers, strides) -> bool:
    """4-element vector loads: data pointers on 16 (f32) / 8 (bf16) bytes and
    (b, t, h) strides that are multiples of 4 elements."""
    align = 16 if dtype == torch.float32 else 8
    return all(p % align == 0 for p in pointers) and all(x % 4 == 0 for x in strides)


def attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 backward: the kernel for CUDA tensors, the plain version for CPU
    tensors.  Returns contiguous (dq, dk, dv) in the input dtype.  Two calls
    on the same inputs give bit-identical results.  Calls on one device must
    not run concurrently (they share the dq merge counters, `_counters`)."""
    global bwd_launches
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, out, dout, lse, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_bwd: no kernel for device {q.device}")
    _check_shapes(q, k, v)
    strides = build.attention_strides("attention_bwd", q, k, v, _BWD, BWD_HEAD_DIMS)
    B, T, H, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {out.shape} {out.dtype} and dout {dout.shape} {dout.dtype} must match q")
    if lse.shape != (B * H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 (B*H, T) = {(B * H, T)}, got {lse.shape} {lse.dtype}")
    # autograd may hand over a view with a strided head dim (e.g. an expand)
    if out.stride(-1) != 1:
        out = out.contiguous()
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    index = q.get_device()
    if out.get_device() != index or dout.get_device() != index or lse.get_device() != index:
        raise ValueError("attention_bwd inputs on different devices")
    scale = scale if scale is not None else D**-0.5
    plan = bwd_plan(B, T, H, D)
    dq, dk, dv = torch.empty((3, B, T, H, D), dtype=q.dtype, device=q.device).unbind(0)
    dq_part = counters = None
    if plan["counters"]:
        dq_part = torch.empty(plan["dq_part"], dtype=torch.float32, device=q.device)
        counters = _counters.get(index)
        if counters is None or counters.numel() < plan["counters"]:
            counters = _counters[index] = torch.zeros(max(plan["counters"], 4096), dtype=torch.int32,
                                                      device=q.device)
    strides += out.stride()[:3] + dout.stride()[:3]
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr())
    vec = int(_vec_ok(q.dtype, pointers, strides))

    def pack(stream: int) -> bytes:
        return BWD_ARGS.pack(*pointers, lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             dq_part.data_ptr() if dq_part is not None else 0,
                             counters.data_ptr() if counters is not None else 0, stream, *strides,
                             B, T, H, D, plan["tile"], vec, scale)

    build.launch_packed(_BWD[q.dtype], index, pack)
    bwd_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """K4 with its backward: saves (q, k, v, out, lse) in the forward and
    runs `attention_bwd` (the kernel on CUDA, the plain version on CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = fused_attention_with_lse(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, ctx.scale)
        return dq, dk, dv, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Self-attention over (B, T, H, D): the kernel on CUDA, the plain
    version on CPU; differentiable through `FusedAttention` when a
    gradient is needed, the forward alone otherwise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.is_cuda and q.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"fused_attention: the K4 backward takes head dims {BWD_HEAD_DIMS}, not head dim "
                             f"{q.shape[-1]}; train with attn_impl='xla' (ROADMAP.md Queue 2)")
        return FusedAttention.apply(q, k, v, scale)
    return fused_attention_with_lse(q, k, v, scale)[0]
