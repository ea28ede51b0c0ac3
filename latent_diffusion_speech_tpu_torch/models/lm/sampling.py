"""Autoregressive sampling (HF `generate` semantics) as plain PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/lm/sampling.py`.  The
processor order is the same: repetition penalty -> bad-words ban -> end gate
(force EOS when p(EOS) > threshold) -> temperature -> fused top-k / top-p ->
categorical sample.  `ar_generate` is the plain decode loop; the K1 kernel
(`ops/kernels/ar_decode.py`) runs the same loop on the card.

Sampling draws Gumbel noise from an explicit `torch.Generator`; it gives other
numbers than `jax.random`, so sampled trajectories agree in distribution only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

__all__ = ["SamplingConfig", "process_logits", "sample_token", "ar_generate"]


@dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 1024
    do_sample: bool = True
    temperature: float = 1.0
    top_k: int = 5
    top_p: float = 0.8
    repetition_penalty: float = 1.2
    end_gate_threshold: Optional[float] = None
    eos_token_id: int = 0
    pad_token_id: int = 0
    bos_token_id: int = 0
    ban_until: int = 0  # ban token ids < ban_until (llama bad_words_ids)
    # kept for field parity with the JAX config; the plain loop does not unroll
    scan_unroll: int = 4


def _top_k_vals(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k VALUES (descending) of (B, V) logits as k rounds of (max, mask
    every value >= max): exactly tied values collapse into one slot, as in
    the JAX version (and the K1 kernel)."""
    if k > 16:
        return torch.topk(logits, k, dim=-1).values
    vals = []
    x = logits
    for _ in range(k):
        m = x.max(dim=-1).values
        vals.append(m)
        x = x.masked_fill(x >= m[:, None], float("-inf"))
    return torch.stack(vals, dim=-1)


def process_logits(
    logits: torch.Tensor, generated_mask: torch.Tensor, cfg: SamplingConfig
) -> torch.Tensor:
    """Apply the processors to (B, V) logits. generated_mask (B, V) bool:
    True where the token id already appeared (repetition penalty)."""
    logits = logits.float()
    neg_inf = float("-inf")
    v_ids = torch.arange(logits.shape[-1], device=logits.device)

    if cfg.repetition_penalty != 1.0:
        penalized = torch.where(
            logits > 0, logits / cfg.repetition_penalty, logits * cfg.repetition_penalty
        )
        logits = torch.where(generated_mask, penalized, logits)

    if cfg.ban_until > 0:
        logits = logits.masked_fill(v_ids[None, :] < cfg.ban_until, neg_inf)

    if cfg.end_gate_threshold is not None:
        p_eos = torch.softmax(logits, dim=-1)[:, cfg.eos_token_id]
        gate = p_eos > cfg.end_gate_threshold
        forced = torch.full_like(logits[:1], neg_inf)
        forced[:, cfg.eos_token_id] = 0.0
        logits = torch.where(gate[:, None], forced, logits)

    if cfg.do_sample and cfg.temperature != 1.0:
        logits = logits / cfg.temperature

    if cfg.do_sample and cfg.top_k > 0 and cfg.top_p < 1.0:
        # fused top-k + top-p: the k survivors come out ordered, so the
        # nucleus cutoff needs no full-vocab sort
        k = min(cfg.top_k, logits.shape[-1])
        top_vals = _top_k_vals(logits, k)  # (B, k), descending
        kth = top_vals[:, -1:]
        probs = torch.softmax(top_vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = cum - probs > cfg.top_p  # True = dropped (the first is always kept)
        thresh = torch.where(cutoff, float("inf"), top_vals).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < torch.maximum(thresh, kth), neg_inf)
    elif cfg.do_sample and cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])
        top_vals = _top_k_vals(logits, k)
        logits = logits.masked_fill(logits < top_vals[:, -1:], neg_inf)
    elif cfg.do_sample and cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_mask = cum - probs > cfg.top_p
        sorted_logits = sorted_logits.masked_fill(cutoff_mask, neg_inf)
        thresh = torch.where(cutoff_mask, float("inf"), sorted_logits).min(
            dim=-1, keepdim=True
        ).values
        logits = logits.masked_fill(logits < thresh, neg_inf)

    return logits


def sample_token(
    logits: torch.Tensor, generator: Optional[torch.Generator], do_sample: bool
) -> torch.Tensor:
    """(B, V) processed logits -> (B,) token ids: Gumbel-max when sampling
    (the same distribution as a categorical draw), argmax (lowest index on
    ties) when not."""
    if do_sample:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        logits = logits - torch.log(-torch.log(u))
    return torch.argmax(logits, dim=-1)


def ar_generate(
    step_fn: Callable,
    init_carry,
    first_token: torch.Tensor,
    vocab_size: int,
    cfg: SamplingConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain AR loop.

    step_fn(carry, token (B,), pos int) -> (carry, logits (B, V)) runs the
    model for one token.  Returns (tokens (B, max_new_tokens) int32,
    lengths (B,) int32): PAD after EOS; lengths count the EOS.  Like the JAX
    scan it always runs max_new_tokens steps."""
    B = first_token.shape[0]
    device = first_token.device
    rep_mask = torch.zeros((B, vocab_size), dtype=torch.bool, device=device)
    rep_mask[torch.arange(B, device=device), first_token] = True
    finished = torch.zeros((B,), dtype=torch.bool, device=device)
    lengths = torch.zeros((B,), dtype=torch.int32, device=device)
    token = first_token
    carry = init_carry
    out = []
    for pos in range(cfg.max_new_tokens):
        carry, logits = step_fn(carry, token, pos)
        logits = process_logits(logits, rep_mask, cfg)
        nxt = sample_token(logits, generator, cfg.do_sample)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id), nxt)
        lengths += (~finished).to(torch.int32)
        finished = finished | (nxt == cfg.eos_token_id)
        rep_mask[torch.arange(B, device=device), nxt] = True
        out.append(nxt)
        token = nxt
    return torch.stack(out, dim=1).to(torch.int32), lengths
