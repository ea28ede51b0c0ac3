"""Ring attention: exact attention with q, k and v split over the mesh's
`seq` axis.

Counterpart of `latent_diffusion_speech_tpu/ops/ring_attention.py`.  Each
rank holds its chunk (B, T / n, H, D) of the sequence; it attends its q
chunk against the k/v block it holds, keeps FlashAttention's online-softmax
accumulators (m, l, acc) in f32, and passes the block (with its key-padding
mask) to the next rank of the ring, n blocks in all, so every q chunk sees
every k/v block.  Causal masking uses the blocks' global offsets: rank r's
queries start at r T / n and the block that came from rank src at
src T / n; a block wholly above the diagonal is passed on without a
product (its probabilities are all zero).  Rows whose every key is masked
(padding that spans whole blocks) give zeros, as JAX's guard does: a
probability is taken only where the logit was not masked.

The JAX op rotates with `lax.ppermute` inside `shard_map`, and reverse-mode
AD runs the transposed ring.  Here the rotation is one `batch_isend_irecv`
a step over the `seq` group (the send to the next rank and the receive from
the previous one posted together), inside an `autograd.Function` whose
backward runs the ring the other way: each rank recomputes its rows'
probabilities against each block from the saved row maxima and sums, adds
its rows' share of dq, and adds its share of that block's dk and dv to
accumulators that travel with the block, which are home after n steps.
Without a group (or with a `seq` axis of 1) it is one local block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from latent_diffusion_speech_tpu_torch.parallel.dist import exchange
from latent_diffusion_speech_tpu_torch.parallel.mesh import AXIS_SEQ

__all__ = ["ring_attention", "NEG_INF"]

NEG_INF = -1e30


def _shift(tensors: Sequence[torch.Tensor], to: int, frm: int, group) -> List[torch.Tensor]:
    """Send `tensors` to global rank `to` and receive their like from `frm`."""
    return exchange(tensors, to, [(t.shape, t.dtype, t.device) for t in tensors], frm, group)


def _logits(q, k, scale, q_off, k_off, is_causal, kv_mask):
    """(B, H, Tq, Tk) f32 logits of q against one block, NEG_INF where masked."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        rows = q_off + torch.arange(q.shape[1], device=q.device)
        cols = k_off + torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(~(rows[:, None] >= cols[None, :]), NEG_INF)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    return logits


class _Ring:
    """The ring's geometry: n ranks, this one's place, its neighbours'
    global ranks and the group."""

    def __init__(self, mesh, axis: str):
        self.n = mesh.axis_size(axis) if mesh is not None else 1
        self.my = mesh.coordinate(axis) if self.n > 1 else 0
        if self.n > 1:
            self.group = mesh.axis_group((axis,))
            self.next = mesh.peer(axis, (self.my + 1) % self.n)
            self.prev = mesh.peer(axis, (self.my - 1) % self.n)

    def skipped(self, src: int, is_causal: bool) -> bool:
        """A causal block wholly above the diagonal (every key after every query)."""
        return is_causal and src > self.my


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ring: _Ring, is_causal: bool, scale: float):
        B, T, H, D = q.shape
        m = torch.full((B, H, T, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, T, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, T, H, v.shape[-1]), dtype=torch.float32, device=q.device)
        kb, vb, mb = k, v, kv_mask
        for i in range(ring.n):
            src = (ring.my - i) % ring.n
            if not ring.skipped(src, is_causal):
                logits = _logits(q, kb, scale, ring.my * T, src * T, is_causal, mb)
                m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
                p = torch.where(logits > 0.5 * NEG_INF, torch.exp(logits - m_new), 0.0)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha.transpose(1, 2) + torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
                m = m_new
            if i < ring.n - 1:
                kb, vb, *rest = _shift([kb, vb] + ([mb] if mb is not None else []), ring.next, ring.prev, ring.group)
                mb = rest[0] if rest else None
        out = acc / l.transpose(1, 2).clamp_min(1e-30)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.ring, ctx.is_causal, ctx.scale = ring, is_causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        ring, is_causal, scale = ctx.ring, ctx.is_causal, ctx.scale
        T = q.shape[1]
        g = grad.float()
        delta = (g * out).sum(dim=-1).transpose(1, 2)[..., None]  # (B, H, Tq, 1): rowsum(dO o O)
        inv_l = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), 0.0)
        qf = q.float()
        dq = torch.zeros_like(qf)
        kb, vb, mb = k, v, kv_mask
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        # the reverse ring: block (my + i) % n at step i, its dk / dv travelling with it
        for i in range(ring.n):
            src = (ring.my + i) % ring.n
            if not ring.skipped(src, is_causal):
                logits = _logits(q, kb, scale, ring.my * T, src * T, is_causal, mb)
                p = torch.where(logits > 0.5 * NEG_INF, torch.exp(logits - m), 0.0) * inv_l
                dp = torch.einsum("bqhd,bkhd->bhqk", g, vb.float())
                ds = p * (dp - delta)
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
                dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, g)
            if ring.n > 1:
                moving = [dk, dv] + ([kb, vb] + ([mb] if mb is not None else []) if i < ring.n - 1 else [])
                moved = _shift(moving, ring.prev, ring.next, ring.group)
                dk, dv = moved[:2]
                if i < ring.n - 1:
                    kb, vb = moved[2:4]
                    mb = moved[4] if mb is not None else None
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = AXIS_SEQ,
                   is_causal: bool = False, scale: Optional[float] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention of this rank's chunk of a sequence split over
    `axis` of `mesh` (a `parallel.mesh.Mesh`): q, k, v (B, T / n, H, D),
    the chunks of one global (B, T, H, D) each, rank r holding tokens
    [r T / n, (r + 1) T / n); returns this rank's rows of the output.
    kv_mask: optional (B, T / n) bool key-padding mask (True = attend), this
    rank's chunk; it travels with its k/v block.  Differentiable: the
    backward is a collective too, which every rank of the ring runs."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring_attention: q and k chunks of {q.shape[1]} and {k.shape[1]} tokens; "
                         "the ring takes self-attention over one sequence")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = kv_mask.bool() if kv_mask is not None else None
    return _RingAttention.apply(q, k, v, mask, _Ring(mesh, axis), is_causal, float(scale))
