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
raises.

Sequence parallelism (`sequence_parallel(mesh)`, JAX's context): inside
it each rank's tensors are its chunk of the sequence along the mesh's
`seq` axis, token dimension 1, rank r holding tokens [r T / n, (r + 1) T /
n).  A call qualifies for the ring (`ops/ring_attention.py`) by JAX's rule
(`_ring_eligible`): no bias, no attention dropout, q and k chunks of one
length (JAX's `Tq == Tk`; a global length is n times a chunk, so it divides
by n), and at most a (B, 1, 1, Tk) key-padding mask; and it takes the ring
only for `impl="xla"`, as JAX routes.  Every other call takes the path its
`impl` names over the whole sequence, as JAX's global program does: the
rank gathers every chunk of k and v (and of a key-padding mask or bias
given over its keys) and runs its own rows of queries against them, a
causal mask turned into an explicit one at its rows' global offsets (the
JAX plain path's bottom-right alignment).  A bias or mask over every key
is taken as this rank's rows of it.  Attention dropout inside the context
raises: the ring has none, and the LM trainer refuses `parallel.seq > 1`
with it as JAX's does.  `sequence_offset` gives a chunk's first global
position (the models' rotary tables).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from latent_diffusion_speech_tpu_torch.ops import ring_attention as ring
from latent_diffusion_speech_tpu_torch.ops.kernels.flash_attention import flash_attention
from latent_diffusion_speech_tpu_torch.ops.kernels.fused_attention import fused_attention
from latent_diffusion_speech_tpu_torch.parallel import mesh as rows
from latent_diffusion_speech_tpu_torch.parallel.tensor import gather_summed

__all__ = ["dot_product_attention", "dropout", "rotate_half", "apply_rotary", "MAX_FUSED_T",
           "sequence_parallel", "sequence_offset", "current_sequence_parallel"]

MAX_FUSED_T = 512  # the JAX package's cap on the single-block K4 route

# the active sequence-parallel contexts, a stack of (mesh, axis)
_seq_parallel: list = []


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "seq"):
    """Inside, tensors are this rank's chunks of a sequence split over
    `axis` of `mesh` (a `parallel.mesh.Mesh`), and eligible self-attention
    runs the ring (see the module's docstring)."""
    _seq_parallel.append((mesh, axis))
    try:
        yield
    finally:
        _seq_parallel.pop()


def current_sequence_parallel():
    """A context manager factory that re-enters the sequence-parallel
    contexts active now: a recompute in a backward (`remat`) runs after the
    caller's contexts have closed, and must route as the forward did."""
    saved = list(_seq_parallel)

    @contextlib.contextmanager
    def reenter():
        outer = list(_seq_parallel)
        _seq_parallel[:] = saved
        try:
            yield
        finally:
            _seq_parallel[:] = outer

    return reenter


@contextlib.contextmanager
def _outside():
    """The context suspended: a call on gathered tensors is a plain one."""
    saved = list(_seq_parallel)
    _seq_parallel.clear()
    try:
        yield
    finally:
        _seq_parallel.extend(saved)


def _active():
    """(mesh, axis, n) of the innermost context whose axis is above 1, or None."""
    if not _seq_parallel:
        return None
    mesh, axis = _seq_parallel[-1]
    n = mesh.axis_size(axis)
    return (mesh, axis, n) if n > 1 else None


def sequence_offset(t_local: int) -> int:
    """The first global position of this rank's chunk of `t_local` tokens
    (0 outside a sequence-parallel context)."""
    active = _active()
    return 0 if active is None else active[0].coordinate(active[1]) * t_local


def _ring_eligible(q, k, bias, mask, dropout_rate, generator):
    """(mesh, axis, kv_mask) when the call qualifies for the ring by JAX's
    rule, else None."""
    active = _active()
    if active is None or bias is not None:
        return None
    if dropout_rate > 0.0 and generator is not None:
        return None
    if q.shape[1] != k.shape[1]:
        return None
    kv_mask = None
    if mask is not None:
        if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1 or mask.shape[-1] != k.shape[1]:
            return None
        kv_mask = mask[:, 0, 0, :].bool()
    return active[0], active[1], kv_mask


def _over_keys(x: Optional[torch.Tensor], k_local: int, group) -> Optional[torch.Tensor]:
    """A key-padding mask or bias (one row for every query) over this
    rank's keys gathered over every chunk's; one over every key as it is."""
    if x is None or x.shape[-1] != k_local:
        return x
    if x.dim() >= 2 and x.shape[-2] != 1:
        raise ValueError("sequence parallelism: a mask or bias with rows of queries must cover every key "
                         f"(got {x.shape[-1]} keys, this rank's chunk)")
    if x.is_floating_point():
        return gather_summed(x, group, -1)
    sent = x.to(torch.uint8).contiguous()  # a bool mask travels as bytes
    out = [torch.empty_like(sent) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, sent, group=group)
    return torch.cat(out, dim=-1).to(x.dtype)


def _whole_sequence(q, k, v, bias, mask, is_causal, scale, impl, dropping):
    """A call that does not take the ring, inside the context: this rank's
    rows of queries against every chunk's keys (see the module's docstring)."""
    mesh, axis, n = _active()
    if dropping:
        raise ValueError("attention-probability dropout under sequence parallelism: ring attention has none "
                         "(parallel.seq > 1 requires attention_probs_dropout_prob=0)")
    group = mesh.axis_group((axis,))
    k_local = k.shape[1]
    k_all, v_all = gather_summed(k, group, 1), gather_summed(v, group, 1)
    mask, bias = _over_keys(mask, k_local, group), _over_keys(bias, k_local, group)
    if is_causal:
        t_q, t_kv = q.shape[1] * n, k_all.shape[1]
        rows_ = mesh.coordinate(axis) * q.shape[1] + torch.arange(q.shape[1], device=q.device)
        causal = torch.arange(t_kv, device=q.device)[None, :] <= rows_[:, None] + (t_kv - t_q)
        mask = causal if mask is None else mask.bool() & causal
    with _outside():
        return dot_product_attention(q, k_all, v_all, bias=bias, mask=mask, scale=scale, impl=impl)


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
    if _active() is not None:
        eligible = _ring_eligible(q, k, bias, mask, dropout_rate, generator)
        if eligible is not None and impl == "xla":
            mesh, axis, kv_mask = eligible
            return ring.ring_attention(q, k, v, mesh, axis=axis, is_causal=is_causal, scale=scale, kv_mask=kv_mask)
        return _whole_sequence(q, k, v, bias, mask, is_causal, scale, impl, dropping)
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
