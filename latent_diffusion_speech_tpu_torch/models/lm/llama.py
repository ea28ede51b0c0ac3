"""Llama decoder-only text -> semantic LM in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/lm/llama.py`: one token
stream `[BOS, phones, EOS, sem_BOS, semantic..., sem_EOS]` with the semantic
ids shifted by the phone vocabulary; HF Llama blocks (pre-norm RMSNorm,
half-split rotary on q/k, biasless projections, a SwiGLU feed-forward or,
with `moe_experts > 0`, the routed expert bank of `ops/moe.py`).  Generation
bans every text token and un-shifts its output.

Submodule and parameter names follow the flax tree (`block_0.q_proj`,
`block_0.moe.w_gate`, ...), so `convert.llama_from_jax` maps one onto the
other.  The forward returns the logits and the MoE layers' auxiliary losses
(the JAX module sows them into a collection).  Attention is the plain path
of `ops/attention.py` (the JAX module's default `impl="xla"`): no Pallas
kernel lies on the JAX Llama, so none lies here.

`generate` fills the cache with the dense model's prompt in one causal
pass, where the JAX version feeds it one token at a time through the cache:
the same function (each row attends to the rows before it), one launch
sequence instead of one a token.  With experts it feeds the prompt one
token a call, as JAX does: an expert's capacity depends on the tokens a call
routes, so a one-pass prefill would drop other tokens.  The decode then
runs one token a step through `models/lm/sampling.py::ar_generate`.  There
is no batched decode over padded prompts (no `attention_mask`), as in the
JAX package: a Llama pipeline serves `tts` and `tts_from_phones`, and
`tts_batch` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, ar_generate
from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
from latent_diffusion_speech_tpu_torch.ops.layers import Dense, cast_compute_dtype, resolve_device, seeded
from latent_diffusion_speech_tpu_torch.ops.moe import MoEMLP
from latent_diffusion_speech_tpu_torch.text.symbols import symbols

__all__ = ["LlamaConfig", "Llama", "LlamaSystem", "RMSNorm", "rotary_half"]

Rotary = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    hidden_size: int = 768
    num_attention_heads: int = 4
    num_hidden_layers: int = 4
    intermediate_size: int = 512
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    mode: str = "phone"
    semantic_kmeans_num: int = 4096
    text_vocab_size: Optional[int] = None
    # MoE feed-forward (0 = dense): routed SwiGLU experts (ops/moe.py)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def token_shift(self) -> int:
        if "phone" in self.mode:
            return len(symbols)
        if self.text_vocab_size is None:
            raise ValueError("text mode needs text_vocab_size")
        return self.text_vocab_size

    @property
    def phone_bos(self) -> int:
        return len(symbols)

    @property
    def phone_eos(self) -> int:
        return len(symbols) + 1

    @property
    def vocab_size(self) -> int:
        return self.token_shift + self.semantic_kmeans_num + 3

    @property
    def bos_token_id(self) -> int:  # the semantic BOS in the shifted space
        return self.token_shift + self.semantic_kmeans_num

    @property
    def eos_token_id(self) -> int:
        return self.token_shift + self.semantic_kmeans_num + 1

    @property
    def pad_token_id(self) -> int:
        return self.token_shift + self.semantic_kmeans_num + 2


def rotary_tables(positions: torch.Tensor, dim: int, theta: float) -> Rotary:
    """HF Llama's half-split (cos, sin) tables in f32: positions (T,) -> (T, dim)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions.float()[:, None] * inv_freq
    return torch.cat([angles.cos(), angles.cos()], dim=-1), torch.cat([angles.sin(), angles.sin()], dim=-1)


def apply_rotary_half(x: torch.Tensor, rotary: Rotary) -> torch.Tensor:
    """x (B, T, H, D) with (cos, sin) (T, D), cast to x's dtype."""
    cos, sin = (t[None, :, None, :].to(x.dtype) for t in rotary)
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def rotary_half(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """HF Llama rotary, the half-split convention. x (B, T, H, D)."""
    return apply_rotary_half(x, rotary_tables(positions, x.shape[-1], theta))


class RMSNorm(nn.Module):
    """The JAX RMSNorm: the mean square in f32, x scaled by its inverse root
    and cast back to x's dtype, then times the f32 scale (so a bf16 input
    gives an f32 output)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        C, F_ = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.input_ln = RMSNorm(C, cfg.rms_norm_eps)
        self.q_proj = Dense(C, C, bias=False)
        self.k_proj = Dense(C, C, bias=False)
        self.v_proj = Dense(C, C, bias=False)
        self.o_proj = Dense(C, C, bias=False)
        self.post_ln = RMSNorm(C, cfg.rms_norm_eps)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(C, cfg.moe_experts, F_, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor)
        else:
            self.gate_proj = Dense(C, F_, bias=False)
            self.up_proj = Dense(C, F_, bias=False)
            self.down_proj = Dense(F_, C, bias=False)

    def forward(self, x: torch.Tensor, rotary: Rotary, mask: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, T, C) at the positions of `rotary`; causal within the call.
        cache: {'k', 'v'} (B, max_len, H, D): this call's k/v are written at
        `cache_index` IN PLACE (the JAX version returns a new cache) and the
        attention runs over the prefix [0, cache_index + T).  Returns (x,
        the MoE auxiliary loss or None)."""
        B, T, C = x.shape
        H = self.cfg.num_attention_heads
        h = self.input_ln(x)
        q = apply_rotary_half(self.q_proj(h).reshape(B, T, H, C // H), rotary)
        k = apply_rotary_half(self.k_proj(h).reshape(B, T, H, C // H), rotary)
        v = self.v_proj(h).reshape(B, T, H, C // H)
        if cache is not None:
            cache["k"][:, cache_index : cache_index + T] = k
            cache["v"][:, cache_index : cache_index + T] = v
            k = cache["k"][:, : cache_index + T]
            v = cache["v"][:, : cache_index + T]
        attn = dot_product_attention(q, k, v, mask=mask, is_causal=T > 1)
        x = x + self.o_proj(attn.reshape(B, T, C))
        h = self.post_ln(x)
        if self.cfg.moe_experts > 0:
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h)), None


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"block_{i}", LlamaBlock(cfg))
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False)

    @property
    def blocks(self) -> List[LlamaBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_hidden_layers)]

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.compute_dtype

    def _rotary(self, start: int, T: int, device) -> Rotary:
        head_dim = self.cfg.hidden_size // self.cfg.num_attention_heads
        return rotary_tables(torch.arange(start, start + T, device=device), head_dim, self.cfg.rope_theta)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, T) -> (logits (B, T, V), the MoE layers' auxiliary losses:
        one scalar a layer, none for the dense feed-forward), causal."""
        x = self.embed_tokens(input_ids)
        rotary = self._rotary(0, input_ids.shape[1], input_ids.device)
        mask = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        aux = []
        for block in self.blocks:
            x, a = block(x, rotary, mask=mask)
            if a is not None:
                aux.append(a)
        return self.lm_head(self.final_ln(x)), aux

    def init_cache(self, batch: int, max_len: int, device=None):
        cfg = self.cfg
        H = cfg.num_attention_heads
        device = device if device is not None else self.lm_head.weight.device
        shape = (batch, max_len, H, cfg.hidden_size // H)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=device)} for _ in range(cfg.num_hidden_layers)]

    def prefill(self, input_ids: torch.Tensor, caches) -> None:
        """Write the k/v of a whole prompt (B, P), positions 0..P-1, into the
        caches (in place): in one causal pass for the dense feed-forward;
        with experts one token a call, as the JAX decode feeds it, because an
        expert's capacity depends on the number of tokens a call routes."""
        if self.cfg.moe_experts > 0:
            for pos in range(input_ids.shape[1]):
                self.decode_step(input_ids[:, pos], pos, caches)
            return
        x = self.embed_tokens(input_ids)
        rotary = self._rotary(0, input_ids.shape[1], input_ids.device)
        for block, cache in zip(self.blocks, caches):
            x, _ = block(x, rotary, cache=cache, cache_index=0)

    def decode_step(self, token: torch.Tensor, pos: int, caches):
        """One token (B,) at position `pos` through the caches (updated in
        place): (logits (B, V), caches)."""
        x = self.embed_tokens(token[:, None])
        rotary = self._rotary(pos, 1, token.device)
        for block, cache in zip(self.blocks, caches):
            x, _ = block(x, rotary, cache=cache, cache_index=pos)
        return self.lm_head(self.final_ln(x))[:, 0], caches


class LlamaSystem:
    """Owns the module on a device; exposes `loss` and `generate`."""

    def __init__(
        self,
        cfg: LlamaConfig,
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
        codebook=None,
        training: bool = False,
    ):
        """device: None means `cuda` (raises without a card).  codebook: a
        (K, C) k-means centroid array that warm-starts the embedding rows
        `len(symbols) - 1 ...` (the reference's offset, one row below the
        semantic ids) when C is the model width (seeded weights only).
        dtype: the products' dtype (norms, embeddings and the router stay
        f32).  training: the module in `train()` mode (it has no dropout)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        module = seeded(lambda: Llama(cfg), seed)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        elif codebook is not None and codebook.shape[1] == cfg.hidden_size:
            lo = len(symbols) - 1
            with torch.no_grad():
                module.embed_tokens.weight[lo : lo + cfg.semantic_kmeans_num] = torch.as_tensor(codebook)
        cast_compute_dtype(module, dtype)
        for m in module.modules():
            if isinstance(m, MoEMLP):
                m.cast_experts(dtype)
        self.module = module.to(self.device).train(training)

    def build_input_ids(self, phone: torch.Tensor, semantic: torch.Tensor) -> torch.Tensor:
        """[BOS, phones, EOS, sem_BOS, semantic + shift, sem_EOS]."""
        cfg = self.cfg
        B = phone.shape[0]

        def col(v):
            return torch.full((B, 1), v, dtype=phone.dtype, device=phone.device)

        if cfg.mode == "phone":
            phone = torch.cat([col(cfg.phone_bos), phone, col(cfg.phone_eos)], dim=1)
        sem = torch.cat([col(cfg.bos_token_id), semantic + cfg.token_shift, col(cfg.eos_token_id)], dim=1)
        return torch.cat([phone, sem], dim=1)

    # the shifted next-token CE in f32 with -100 ignored: the RoFormer's
    _ce = staticmethod(RoformerSystem._ce)

    def loss_of(self, logits: torch.Tensor, aux: List[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
        """The CE plus `moe_aux_weight` times the mean of the layers' Switch
        auxiliary losses (with experts)."""
        ce = self._ce(logits, labels)
        if self.cfg.moe_experts <= 0:
            return ce
        return ce + self.cfg.moe_aux_weight * (sum(aux) / max(len(aux), 1))

    def loss(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        """Causal CE with -100 ignored, plus the MoE auxiliary loss, of a
        collated device batch (`data/lm_dataset.py::collate_llama_batch`).  The
        Llama has no dropout: `generator` is taken for the trainer's sake
        and unused."""
        logits, aux = self.module(batch["input_ids"], batch.get("attention_mask"))
        return self.loss_of(logits, aux, batch["labels"])

    def loss_pp(self, *args, **kwargs):
        """The JAX package's pipeline-parallel loss (GPipe over a mesh
        `pipe` axis): parallelism is not ported (ROADMAP.md Queue 1, item 10)."""
        raise NotImplementedError("Llama pipeline parallelism (loss_pp) is not ported (ROADMAP.md Queue 1, item 10)")

    @torch.no_grad()
    def generate(
        self,
        phone,
        tones=None,
        spk_id=None,
        max_length: int = 1024,
        do_sample: bool = True,
        temperature: float = 1.0,
        top_k: int = 5,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        end_gate_threshold: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns (semantic tokens un-shifted (B, max_length) int32, lengths
        (B,) int32): tokens exclude BOS, include EOS, PAD after EOS.

        `tones` and `spk_id` are taken for interface parity with
        `RoformerSystem.generate` (so `TTSPipeline` serves either LM) and
        ignored: the Llama conditions on the phone stream only."""
        cfg = self.cfg
        phone = torch.as_tensor(phone, device=self.device).long()
        B = phone.shape[0]

        def col(v):
            return torch.full((B, 1), v, dtype=torch.long, device=self.device)

        prompt = torch.cat([col(cfg.phone_bos), phone, col(cfg.phone_eos)], dim=1)
        P = prompt.shape[1]
        caches = self.module.init_cache(B, P + max_length + 1)
        self.module.prefill(prompt, caches)
        sampling = SamplingConfig(
            max_new_tokens=max_length,
            do_sample=do_sample,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            end_gate_threshold=end_gate_threshold,
            eos_token_id=cfg.eos_token_id,
            pad_token_id=cfg.pad_token_id,
            bos_token_id=cfg.bos_token_id,
            ban_until=cfg.token_shift,  # bad words: every text token
        )

        def step(carry, token, idx):
            logits, carry = self.module.decode_step(token, P + idx, carry)
            return carry, logits

        # the semantic BOS is fed first, at position P
        first = torch.full((B,), cfg.bos_token_id, dtype=torch.long, device=self.device)
        tokens, lengths = ar_generate(step, caches, first, cfg.vocab_size, sampling, generator)
        return tokens - cfg.token_shift, lengths
