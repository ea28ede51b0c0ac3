"""RoFormer encoder-decoder text -> semantic LM in PyTorch.

Counterpart of `latent_diffusion_speech_tpu/models/lm/roformer.py`: post-LN
BERT layers, interleaved-pair rotary embeddings on q/k in self-attention only,
embeddings = word + token type (LayerNorm eps 1e-12), a per-token speaker
embedding added to the encoder input, and an LM head (dense -> exact GELU ->
LayerNorm -> decoder projection tied to the semantic embeddings + bias).

Submodule and parameter names follow the flax tree (`enc_0.self_attn.query`,
...), so `convert.roformer_from_jax` maps one onto the other.  Generation runs
through `ops/kernels/ar_decode.py::roformer_decode`: the K1 kernel for CUDA
tensors, the plain decode loop for CPU tensors.

Training: `Roformer.forward` is `encode` + the teacher-forced causal
`decode_train`, and `RoformerSystem.loss` the shifted cross-entropy.  Dropout
(on the attention probabilities, after the attention and FF output
projections, and on the embeddings) is drawn from a `torch.Generator` passed
in; it runs only in `module.train()` with a generator, so a call without one
is deterministic, as flax's `deterministic=True`.

Sequence parallelism (inside `ops/attention.py::sequence_parallel`): every
tensor is this rank's chunk of the tokens, the rotary tables are taken at
the chunk's global positions, self-attention runs the ring and the
decoder's cross-attention the ring too when the encoder and decoder chunks
are of one length (JAX routes it so), else over the gathered encoder
states; `encode_seq_parallel` is JAX's entry, and the loss takes targets
already shifted over the chunks' boundaries (`_ce`'s `targets`).  Pipeline
parallelism: `RoformerSystem.loss_pp`, JAX's slot layout over
`parallel/pipeline.py`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu_torch.text.symbols import num_tones, symbols
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig
from latent_diffusion_speech_tpu_torch.ops.attention import (dot_product_attention, dropout, sequence_offset,
                                                             sequence_parallel)
from latent_diffusion_speech_tpu_torch.ops.layers import (Dense, LayerNorm, cast_compute_dtype, keep_split, local_heads,
                                                          resolve_device, seeded)

__all__ = ["StackConfig", "RoformerConfig", "Roformer", "RoformerSystem", "rotary_sin_cos"]

Generator = Optional[torch.Generator]


@dataclass(frozen=True)
class StackConfig:
    hidden_size: int = 256
    num_attention_heads: int = 8
    num_hidden_layers: int = 4
    intermediate_size: int = 512
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 3072


@dataclass(frozen=True)
class RoformerConfig:
    encoder: StackConfig = field(default_factory=StackConfig)
    decoder: StackConfig = field(default_factory=lambda: StackConfig(num_hidden_layers=1))
    mode: str = "phone"
    semantic_kmeans_num: int = 4096
    n_spk: int = 323
    text_vocab_size: Optional[int] = None  # for mode="text": external tokenizer vocab

    @property
    def phone_vocab_size(self) -> int:
        if "phone" in self.mode:
            return len(symbols) + 3
        if self.text_vocab_size is None:
            raise ValueError("text mode needs text_vocab_size")
        return self.text_vocab_size

    @property
    def num_token_types(self) -> int:
        return (num_tones + 1) if "phone" in self.mode else 1

    @property
    def phone_bos(self) -> int:
        return len(symbols) if "phone" in self.mode else 101  # BERT [CLS]

    @property
    def phone_eos(self) -> int:
        return len(symbols) + 1 if "phone" in self.mode else 102  # BERT [SEP]

    @property
    def phone_pad(self) -> int:
        return len(symbols) + 2 if "phone" in self.mode else 0  # BERT [PAD]

    @property
    def semantic_vocab_size(self) -> int:
        return self.semantic_kmeans_num + 3

    @property
    def semantic_bos(self) -> int:
        return self.semantic_kmeans_num

    @property
    def semantic_eos(self) -> int:
        return self.semantic_kmeans_num + 1

    @property
    def semantic_pad(self) -> int:
        return self.semantic_kmeans_num + 2


def rotary_sin_cos(positions: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise-repeated f32 sin/cos: positions (...,) -> (..., dim)."""
    inv_freq = 1.0 / (
        10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    )
    angles = positions.float()[..., None] * inv_freq
    return (
        torch.repeat_interleave(torch.sin(angles), 2, dim=-1),
        torch.repeat_interleave(torch.cos(angles), 2, dim=-1),
    )


def apply_rotary_pairs(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); sin/cos (T, D), cast to x's dtype."""
    sin = sin[None, :, None, :].to(x.dtype)
    cos = cos[None, :, None, :].to(x.dtype)
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


class Attention(nn.Module):
    def __init__(self, cfg: StackConfig, use_rotary: bool = True):
        super().__init__()
        C = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.use_rotary = use_rotary
        self.dropout_rate = cfg.attention_probs_dropout_prob
        self.query = Dense(C, C)
        self.key = Dense(C, C)
        self.value = Dense(C, C)
        self.out = Dense(C, C)

    @property
    def heads(self) -> int:
        """The heads this rank runs (all of them without tensor parallelism)."""
        return getattr(self, "_local_heads", self.n_heads)

    def plan_tensor_parallel(self) -> None:
        self._local_heads = local_heads(self.n_heads, (self.query, self.key, self.value), self.out)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        return x.reshape(B, T, self.heads, C // self.heads)

    def kv(self, source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._heads(self.key(source)), self._heads(self.value(source))

    def forward(
        self,
        x: torch.Tensor,
        kv_source: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        is_causal: bool = False,
        generator: Generator = None,
    ) -> torch.Tensor:
        """Self-attention (kv_source None) or cross-attention.

        cache: {'k', 'v'} (B, max_len, H, D); the step's k/v are written at
        `cache_index` IN PLACE (the JAX version returns a new cache) and the
        attention runs over the prefix [0, cache_index].
        rotary: precomputed (sin, cos) (T, D) for this call's positions.
        generator: attention-probability dropout (None: off)."""
        B, T, C = x.shape
        q = self._heads(self.query(x))
        if kv_override is not None:
            k, v = kv_override
        else:
            k, v = self.kv(x if kv_source is None else kv_source)
        if self.use_rotary and kv_source is None and kv_override is None:
            if rotary is None:
                if positions is None:  # the chunk's global positions under sequence parallelism
                    positions = torch.arange(T, device=x.device) + sequence_offset(T)
                rotary = rotary_sin_cos(positions, C // self.n_heads)  # C: the input's (whole) width
            sin, cos = rotary
            q = apply_rotary_pairs(q, sin, cos)
            k = apply_rotary_pairs(k, sin, cos)
        if cache is not None:
            cache["k"][:, cache_index : cache_index + T] = k
            cache["v"][:, cache_index : cache_index + T] = v
            k = cache["k"][:, : cache_index + T]
            v = cache["v"][:, : cache_index + T]
        split = self.query.split if self.heads != self.n_heads else None
        out = dot_product_attention(q, k, v, mask=mask, is_causal=is_causal and cache is None,
                                    dropout_rate=self.dropout_rate, generator=generator,
                                    dropout_split=None if split is None else (1, split.index, split.size))
        return self.out(out.reshape(B, T, -1))


class Layer(nn.Module):
    """Post-LN transformer layer (HF Bert/RoFormer style) with the
    reference's hidden-dropout placement: after the attention and FF output
    projections, before each residual + LayerNorm."""

    def __init__(self, cfg: StackConfig, cross_attention: bool = False):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dropout_rate = cfg.hidden_dropout_prob
        self.self_attn = Attention(cfg)
        self.self_ln = LayerNorm(C, eps)
        self.cross_attention = cross_attention
        if cross_attention:
            self.cross_attn = Attention(cfg, use_rotary=False)
            self.cross_ln = LayerNorm(C, eps)
        self.ff_in = Dense(C, cfg.intermediate_size)
        self.ff_out = Dense(cfg.intermediate_size, C)
        self.ff_ln = LayerNorm(C, eps)

    def plan_tensor_parallel(self) -> None:
        """The FF hidden stays split between ff_in and ff_out when they are
        column- and row-parallel (the GELU acts element by element)."""
        keep_split((self.ff_in,), self.ff_out)

    def forward(
        self,
        x: torch.Tensor,
        enc_states: Optional[torch.Tensor] = None,
        self_mask: Optional[torch.Tensor] = None,
        cross_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        rotary=None,
        cache=None,
        cache_index: Optional[int] = None,
        cross_kv=None,
        is_causal: bool = False,
        generator: Generator = None,
    ) -> torch.Tensor:
        """generator: dropout (None: off; the caller passes one only in
        training mode)."""
        dtype = self.ff_in.compute_dtype
        p = self.dropout_rate
        h = self.self_attn(
            x, mask=self_mask, positions=positions, rotary=rotary,
            cache=cache, cache_index=cache_index, is_causal=is_causal, generator=generator,
        )
        x = self.self_ln(x + dropout(h, p, generator)).to(dtype)
        if self.cross_attention and (enc_states is not None or cross_kv is not None):
            h = self.cross_attn(x, kv_source=enc_states, mask=cross_mask, kv_override=cross_kv,
                                generator=generator)
            x = self.cross_ln(x + dropout(h, p, generator)).to(dtype)
        h = self.ff_out(F.gelu(self.ff_in(x)))
        return self.ff_ln(x + dropout(h, p, generator)).to(dtype)


class Roformer(nn.Module):
    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        self.cfg = cfg
        ecfg, dcfg = cfg.encoder, cfg.decoder
        self.phone_embed = nn.Embedding(cfg.phone_vocab_size, ecfg.hidden_size)
        self.tone_embed = nn.Embedding(cfg.num_token_types, ecfg.hidden_size)
        self.enc_emb_ln = LayerNorm(ecfg.hidden_size, ecfg.layer_norm_eps)
        for i in range(ecfg.num_hidden_layers):
            self.add_module(f"enc_{i}", Layer(ecfg))
        self.has_spk = bool(cfg.n_spk and cfg.n_spk > 1)
        if self.has_spk:
            self.spk_embed = nn.Embedding(cfg.n_spk + 1, ecfg.hidden_size)
        self.semantic_embed = nn.Embedding(cfg.semantic_vocab_size, dcfg.hidden_size)
        self.dec_type_embed = nn.Embedding(1, dcfg.hidden_size)
        self.dec_emb_ln = LayerNorm(dcfg.hidden_size, dcfg.layer_norm_eps)
        for i in range(dcfg.num_hidden_layers):
            self.add_module(f"dec_{i}", Layer(dcfg, cross_attention=True))
        self.head_transform = Dense(dcfg.hidden_size, dcfg.hidden_size)
        self.head_ln = LayerNorm(dcfg.hidden_size, dcfg.layer_norm_eps)
        self.head_bias = nn.Parameter(torch.zeros(cfg.semantic_vocab_size))

    @property
    def encoder_layers(self) -> List[Layer]:
        return [getattr(self, f"enc_{i}") for i in range(self.cfg.encoder.num_hidden_layers)]

    @property
    def decoder_layers(self) -> List[Layer]:
        return [getattr(self, f"dec_{i}") for i in range(self.cfg.decoder.num_hidden_layers)]

    @property
    def dtype(self) -> torch.dtype:
        return self.head_transform.compute_dtype

    def _generator(self, generator: Generator) -> Generator:
        """The dropout generator: only in training mode."""
        return generator if self.training else None

    def encode(self, phone, tone, spk_id=None, attention_mask=None, generator: Generator = None) -> torch.Tensor:
        """phone/tone (B, L) -> encoder states (B, L, C)."""
        gen = self._generator(generator)
        x = self.phone_embed(phone) + self.tone_embed(tone)
        x = self.enc_emb_ln(x).to(self.dtype)
        if self.has_spk and spk_id is not None:
            x = x + self.spk_embed(spk_id)
        x = dropout(x, self.cfg.encoder.hidden_dropout_prob, gen)
        mask = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        for layer in self.encoder_layers:
            x = layer(x, self_mask=mask, generator=gen)
        return x

    def decode_train(self, semantic, enc_states, self_mask=None, cross_mask=None,
                     generator: Generator = None) -> torch.Tensor:
        """Teacher-forced causal decode: semantic (B, S) ids -> logits
        (B, S, V). self_mask (B, S) / cross_mask (B, L): 1 = attend."""
        gen = self._generator(generator)
        x = self.semantic_embed(semantic) + self.dec_type_embed(torch.zeros_like(semantic))
        x = self.dec_emb_ln(x).to(self.dtype)
        x = dropout(x, self.cfg.decoder.hidden_dropout_prob, gen)
        sm = self_mask[:, None, None, :].bool() if self_mask is not None else None
        cm = cross_mask[:, None, None, :].bool() if cross_mask is not None else None
        for layer in self.decoder_layers:
            x = layer(x, enc_states=enc_states, self_mask=sm, cross_mask=cm, is_causal=True, generator=gen)
        return self._lm_head(x)

    def forward(self, phone, tone, semantic, spk_id=None, encoder_attention_mask=None,
                attention_mask=None, generator: Generator = None) -> torch.Tensor:
        """encode + decode_train -> logits (B, S, V)."""
        enc = self.encode(phone, tone, spk_id, encoder_attention_mask, generator=generator)
        return self.decode_train(semantic, enc, self_mask=attention_mask, cross_mask=encoder_attention_mask,
                                 generator=generator)

    def _lm_head(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.head_transform(x))
        h = self.head_ln(h).to(self.dtype)
        return h @ self.semantic_embed.weight.T.to(h.dtype) + self.head_bias

    def compute_cross_kv(self, enc_states: torch.Tensor):
        """Per decoder layer (k, v) heads (B, L, H, D) of the encoder states;
        loop-invariant during generation, so computed once."""
        return [layer.cross_attn.kv(enc_states) for layer in self.decoder_layers]

    @property
    def tensor_parallel(self) -> bool:
        """True when some parameter is split over a mesh axis (its layers run
        partitioned products with collectives)."""
        return any(getattr(m, "split", None) for m in self.modules())

    def init_cache(self, batch: int, max_len: int, device=None):
        dcfg = self.cfg.decoder
        H = self.decoder_layers[0].self_attn.heads if self.decoder_layers else dcfg.num_attention_heads
        D = dcfg.hidden_size // dcfg.num_attention_heads
        device = device if device is not None else self.head_bias.device
        return [
            {
                "k": torch.zeros((batch, max_len, H, D), dtype=self.dtype, device=device),
                "v": torch.zeros((batch, max_len, H, D), dtype=self.dtype, device=device),
            }
            for _ in range(dcfg.num_hidden_layers)
        ]

    def decode_step(self, token, pos: int, caches, enc_states=None, cross_mask=None,
                    cross_kvs=None, rotary_tables=None):
        """One decode step. token (B,), pos int; caches from `init_cache`
        (updated in place). rotary_tables: optional (max_len, D) sin/cos.
        Returns (logits (B, V), caches)."""
        tok = token[:, None]
        x = self.semantic_embed(tok) + self.dec_type_embed(torch.zeros_like(tok))
        x = self.dec_emb_ln(x).to(self.dtype)
        cm = cross_mask[:, None, None, :].bool() if cross_mask is not None else None
        if rotary_tables is not None:
            rot = (rotary_tables[0][pos : pos + 1], rotary_tables[1][pos : pos + 1])
        else:
            D = self.cfg.decoder.hidden_size // self.cfg.decoder.num_attention_heads
            rot = rotary_sin_cos(torch.tensor([pos], device=x.device), D)
        if cross_kvs is None:
            cross_kvs = [None] * len(self.decoder_layers)
        for layer, cache, ckv in zip(self.decoder_layers, caches, cross_kvs):
            x = layer(
                x, enc_states=enc_states, cross_mask=cm, rotary=rot,
                cache=cache, cache_index=pos, cross_kv=ckv,
            )
        return self._lm_head(x)[:, 0], caches


class RoformerSystem:
    """Owns the module on a device; exposes `loss` and `generate`."""

    def __init__(
        self,
        cfg: RoformerConfig,
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
        codebook=None,
        training: bool = False,
    ):
        """device: None means `cuda` (raises without a card).  codebook: a
        (K, C) k-means centroid array that warm-starts the first K semantic
        embedding rows when C is the decoder width (seeded weights only).
        training: the module in `train()` mode (dropout with a generator),
        else `eval()`."""
        self.cfg = cfg
        self.device = resolve_device(device)
        module = seeded(lambda: Roformer(cfg), seed)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        elif codebook is not None and codebook.shape[1] == cfg.decoder.hidden_size:
            with torch.no_grad():
                module.semantic_embed.weight[: cfg.semantic_kmeans_num] = torch.as_tensor(codebook)
        self.module = cast_compute_dtype(module, dtype).to(self.device).train(training)

    @staticmethod
    def _ce(logits: torch.Tensor, labels: torch.Tensor, denom: Optional[torch.Tensor] = None,
            targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shifted next-token CE (logits[:, :-1] against labels[:, 1:]) in
        f32 over the positions whose label is not -100: the sum of their
        nll over their count, or over `denom` when given (a data-parallel
        rank's share of the global count, `train/lm_trainer.py`).
        targets: each position's next-token target, already shifted (a
        sequence-parallel chunk's, whose last target lies in the next
        chunk); every logit is then scored and `labels` unused."""
        if targets is None:
            logits, targets = logits[:, :-1], labels[:, 1:]
        valid = targets != -100
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, targets, 0).long()[..., None])[..., 0]
        return (nll * valid).sum() / (valid.sum().clamp_min(1) if denom is None else denom)

    def logits(self, batch: Dict[str, torch.Tensor], generator: Generator = None) -> torch.Tensor:
        """The teacher-forced logits (B, S, V) of a collated device batch
        (`data/lm_dataset.py::collate_text_batch`)."""
        return self.module(
            batch["phone"], batch["tone"], batch["semantic"], batch.get("spk_id"),
            batch.get("encoder_attention_mask"), batch.get("attention_mask"), generator=generator,
        )

    def loss(self, batch: Dict[str, torch.Tensor], generator: Generator = None,
             denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Causal CE with -100 ignored (HF convention).  generator: dropout
        when the module is in training mode; None is deterministic, as the
        JAX loss with dropout_rng=None.  denom: the CE's divisor (`_ce`);
        a batch's `targets`, when present, the shifted targets (`_ce`)."""
        return self._ce(self.logits(batch, generator), batch["labels"], denom, batch.get("targets"))

    def encode_seq_parallel(self, phone, tone, spk_id=None, mesh=None) -> torch.Tensor:
        """The text encoder over the mesh's `seq` axis: `phone`, `tone` and
        `spk_id` (B, L) are the whole inputs (every rank of the `seq` group
        passes the same); returns this rank's chunk (B, L / n, C) of the
        encoder states, rank r's tokens [r L / n, (r + 1) L / n), as JAX's
        output is sharded.  Self-attention runs the ring.  L must divide by
        the axis's size.  A collective over the `seq` group (the whole
        encode on a world of one)."""
        n = mesh.axis_size("seq") if mesh is not None and mesh.group is not None else 1
        L = phone.shape[1]
        if L % n != 0:
            raise ValueError(f"encode_seq_parallel: L={L} not divisible by seq={n}")
        c = mesh.coordinate("seq") if n > 1 else 0

        def chunk(a):
            a = torch.as_tensor(a, device=self.device).long()
            return a[:, c * (L // n):(c + 1) * (L // n)]

        spk = chunk(spk_id) if spk_id is not None else None
        with sequence_parallel(mesh) if n > 1 else contextlib.nullcontext():
            return self.module.encode(chunk(phone), chunk(tone), spk)

    def loss_pp(self, phone, tone, semantic_in, labels, mesh, spk_id=None, encoder_attention_mask=None,
                attention_mask=None, *, microbatches: int = 4, remat: bool = False, denom: Optional[torch.Tensor] = None,
                targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder-decoder loss over the mesh's `pipe` axis (JAX's
        `loss_pp`): the activation carries both streams (encoder hidden,
        decoder hidden, encoder mask, decoder mask) and each pipeline slot
        holds one layer of [enc_0 .. enc_{E-1}, dec_0 .. dec_{D-1}] padded
        with identity slots to S ceil((E + D) / S), stage s holding slots
        [s per, (s + 1) per); the decoder slots come after every encoder
        slot, so a microbatch's encoder stream is final when they read it.
        The embeddings and the LM head are replicated on every rank of the
        pipe group, without dropout (the pipeline path is deterministic).
        The inputs are this rank's rows of each of `microbatches`
        microbatches, laid out as JAX splits them over `data`
        (`train/lm_trainer.py::_microbatch_rows`); `denom` and `targets` as
        `loss`.  Returns the loss
        on every rank of the pipe group, its gradient counted once over the
        group (`parallel/pipeline.py::count_once`).  Raises JAX's
        ValueErrors for stacks of two widths and a batch the microbatches
        do not divide."""
        from latent_diffusion_speech_tpu_torch.parallel.pipeline import count_once, pipeline_apply

        cfg, module = self.cfg, self.module
        ecfg, dcfg = cfg.encoder, cfg.decoder
        if (ecfg.hidden_size, ecfg.intermediate_size) != (dcfg.hidden_size, dcfg.intermediate_size):
            raise ValueError(
                "loss_pp: encoder/decoder stacks must share hidden and "
                "intermediate sizes (pipeline slots need one param layout); "
                f"got enc ({ecfg.hidden_size}, {ecfg.intermediate_size}) vs "
                f"dec ({dcfg.hidden_size}, {dcfg.intermediate_size})"
            )
        S = mesh.axis_size("pipe") if mesh is not None else 1
        E, D = ecfg.num_hidden_layers, dcfg.num_hidden_layers
        per = -(-(E + D) // S)
        slots = ([(0, layer) for layer in module.encoder_layers] + [(1, layer) for layer in module.decoder_layers]
                 + [(2, None)] * (S * per - (E + D)))
        stages = [slots[s * per:(s + 1) * per] for s in range(S)]
        B, Le = phone.shape
        Sd = semantic_in.shape[1]
        M = microbatches
        if B % M != 0:
            raise ValueError(f"loss_pp: batch {B} not divisible by microbatches {M}")
        # the replicated embeddings (encode / decode_train without dropout)
        enc_x = module.enc_emb_ln(module.phone_embed(phone) + module.tone_embed(tone)).to(module.dtype)
        if module.has_spk and spk_id is not None:
            enc_x = enc_x + module.spk_embed(spk_id)
        dec_x = module.semantic_embed(semantic_in) + module.dec_type_embed(torch.zeros_like(semantic_in))
        dec_x = module.dec_emb_ln(dec_x).to(module.dtype)
        em = (encoder_attention_mask.bool() if encoder_attention_mask is not None
              else torch.ones((B, Le), dtype=torch.bool, device=phone.device))
        dm = (attention_mask.bool() if attention_mask is not None
              else torch.ones((B, Sd), dtype=torch.bool, device=phone.device))

        def stage_fn(stage, act):
            eh, dh, em, dm = act
            for kind, layer in stage:
                if kind == 0:
                    eh = layer(eh, self_mask=em[:, None, None, :])
                elif kind == 1:
                    dh = layer(dh, enc_states=eh, self_mask=dm[:, None, None, :], cross_mask=em[:, None, None, :],
                               is_causal=True)
            return eh, dh, em, dm

        act = (enc_x.reshape(M, B // M, Le, -1), dec_x.reshape(M, B // M, Sd, -1),
               em.reshape(M, B // M, Le), dm.reshape(M, B // M, Sd))
        _, dec_h, _, _ = pipeline_apply(mesh, stage_fn, stages, act, remat=remat)
        logits = module._lm_head(dec_h.reshape(B, Sd, -1))
        return count_once(self._ce(logits, labels, denom, targets), mesh)

    @torch.no_grad()
    def generate(
        self,
        phone,
        tone,
        spk_id=None,
        attention_mask=None,
        max_length: int = 1024,
        do_sample: bool = True,
        temperature: float = 1.0,
        top_k: int = 5,
        top_p: float = 0.8,
        repetition_penalty: float = 1.2,
        end_gate_threshold: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Reference-shaped generate. Returns (tokens (B, max_length) int32,
        lengths (B,) int32): tokens exclude BOS, include EOS, PAD after EOS.

        On CUDA the K1 kernel runs the whole decode; pure top-p sampling
        (top_k=0, top_p<1) takes the plain loop, because the kernel's nucleus
        cutoff rides the top-k values."""
        from latent_diffusion_speech_tpu_torch.ops.kernels.ar_decode import (
            roformer_decode,
            roformer_decode_plain,
        )

        dev = self.device
        phone = torch.as_tensor(phone, device=dev).long()
        tone = torch.as_tensor(tone, device=dev).long()
        if spk_id is not None:
            spk_id = torch.as_tensor(spk_id, device=dev).long()
            if spk_id.dim() == 0:
                spk_id = torch.full_like(phone, int(spk_id))
        mask = torch.as_tensor(attention_mask, device=dev) if attention_mask is not None else None
        enc = self.module.encode(phone, tone, spk_id, mask)
        cross_kvs = self.module.compute_cross_kv(enc)
        B, L = phone.shape
        if mask is not None:
            # prefix masks (pad-to-bucket on the right) -> valid lengths
            cross_len = mask.to(torch.int32).sum(dim=-1).to(torch.int32)
        else:
            cross_len = torch.full((B,), L, dtype=torch.int32, device=dev)
        sampling = SamplingConfig(
            max_new_tokens=max_length,
            do_sample=do_sample,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            end_gate_threshold=end_gate_threshold,
            eos_token_id=self.cfg.semantic_eos,
            pad_token_id=self.cfg.semantic_pad,
            bos_token_id=self.cfg.semantic_bos,
        )
        decode = roformer_decode
        if (do_sample and top_k <= 0 and top_p < 1.0) or self.module.tensor_parallel:
            # K1 holds a whole model: a model split over ranks decodes through
            # the plain loop, whose layers run the partitioned products
            decode = roformer_decode_plain
        return decode(self.module, sampling, cross_kvs, cross_len, generator=generator)
