"""K1: the whole RoFormer autoregressive decode.

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/ar_decode.py`.
`roformer_decode` launches the CUDA kernel in `csrc/ar_decode.cu` for a model
on the card and runs `roformer_decode_plain` for a model on the CPU; there is
no other path.  The plain version is the decode loop of the JAX scan path:
`Roformer.decode_step` over a KV cache, then `sampling.process_logits` and
`sampling.sample_token`.

Both return (tokens (B, N) int32, lengths (B,) int32): PAD after EOS, the
lengths counting the EOS.  Greedy decoding gives the same tokens on both
paths; sampling draws from the same distribution with other random numbers
(the kernel's Philox stream is seeded from the caller's torch.Generator).

The kernel runs one thread-block cluster of CL blocks per stream; `plan`
is the one place that decides the split (CL, the heads and rows a block
owns, where the KV cache lives, the shared memory a block uses) and the C
side checks what it is handed.  The arguments travel as one `_Args` struct,
whose field offsets the C side asserts.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, ar_generate
from latent_diffusion_speech_tpu_torch.ops.kernels import build

__all__ = ["roformer_decode", "roformer_decode_plain", "plan", "Plan", "max_active_clusters", "MAX_TOP_K"]

MAX_TOP_K = 64
NW = 8  # computing warps a block (csrc/ar_decode.cu; one more warp issues the weight copies)
RED = 112  # floats of block-reduction scratch a block
TASK_BYTES = 32  # one entry of a block's weight-task list
CHUNK = 32768  # bytes of one weight-ring slot (more when a matrix row is longer)
MAX_STAGES = 8  # weight-ring slots at most
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on the H100
_FUNCS = {torch.bfloat16: "ar_decode_bf16", torch.float32: "ar_decode_f32"}
_CLUSTERS = {torch.bfloat16: "ar_decode_max_active_clusters_bf16", torch.float32: "ar_decode_max_active_clusters_f32"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]  # (const ArDecodeArgs*, stream or int*)

# kernel launches since the last reset (chip_smoke.py resets and reads it)
launches = 0
build.counts_launches(__name__, "launches")
_packed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # model -> its packed weights (`_pack`)

_POINTERS = (
    "emb_eff emb head_bias sin_t cos_t emb_ln ht_w ht_b head_ln "
    "wqkv bqkv wo bo self_ln cq_w cq_b co_w co_b cross_ln "
    "ff_in_w ff_in_b ff_out_w ff_out_b ff_ln cross_k cross_v cross_len "
    "kv_cache seed tokens lengths debug_logits"
).split()
_INTS = ("B C H I V L N nl do_sample top_k use_end_gate eos pad bos ban_until "
         "CL nh Vs kv_smem ckv_smem stages chunk smem_bytes").split()
_FLOATS = "eps scale temperature top_p repetition_penalty end_gate".split()


class _Args(ctypes.Structure):
    """Mirror of `struct ArDecodeArgs` in csrc/ar_decode.cu (same order; the
    C side asserts each field's offset with ARG_AT)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in _POINTERS]
        + [(n, ctypes.c_int) for n in _INTS]
        + [(n, ctypes.c_float) for n in _FLOATS]
    )


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class Plan:
    """How one stream's decode splits over a cluster of CL blocks: block r
    owns heads [r nh, (r+1) nh), rows [r C/CL, (r+1) C/CL) of the C-row
    products, [r I/CL, (r+1) I/CL) of ff_in and [r Vs, min(V, (r+1) Vs)) of
    the tied head.  Where a block keeps things: kv_smem, its slice of the KV
    cache in shared memory (else device memory); ckv_smem, its heads of the
    encoder K/V; a ring of `stages` slots of `chunk` bytes through which its
    weight rows stream.  smem_bytes: the block's dynamic shared memory."""

    CL: int
    nh: int
    D: int
    Vs: int
    kv_smem: bool
    ckv_smem: bool
    stages: int
    chunk: int
    smem_bytes: int

    def rows(self, rank: int, C: int, I: int, V: int) -> dict:
        """Block `rank`'s heads and its rows of each product (ranges)."""
        cs, i_s = C // self.CL, I // self.CL
        h0 = rank * self.nh
        return dict(
            heads=range(h0, h0 + self.nh),
            qkv=range(h0 * self.D, (h0 + self.nh) * self.D),
            C=range(rank * cs, (rank + 1) * cs),
            I=range(rank * i_s, (rank + 1) * i_s),
            V=range(min(V, rank * self.Vs), min(V, (rank + 1) * self.Vs)),
        )


def _smem_bytes(C, H, I, V, L, N, nl, CL, elem, kv_smem, ckv_smem, stages, chunk) -> int:
    """csrc/ar_decode.cu `layout(...).total`: a block's f32 buffers, the
    task list, the ring's mbarriers and slots, then the KV cache and the
    encoder K/V when they live in shared memory."""
    nh, D, Vs = H // CL, C // H, -(-V // CL)
    hd, cs, i_s = nh * D, C // CL, I // CL
    floats = (_pad(C, 4) + 2 * _pad(max(C, I), 4) + 3 * _pad(hd, 4) + _pad(max(N, L), 4) + NW * D
              + NW * MAX_TOP_K + _pad(Vs, 4) + _pad(-(-Vs // 4), 4) + _pad(CL * (4 + MAX_TOP_K + 2), 4) + RED
              + (2 + 3 * nl) * 2 * C + _pad(nl * (4 * hd + 3 * cs + i_s) + cs, 4) + _pad(Vs, 4))
    total = 4 * floats + (8 * nl + 2) * TASK_BYTES + _pad(8 * (2 * stages + 5), 16) + stages * chunk
    if kv_smem:
        total += _pad(2 * nl * nh * N * D * elem, 16)
    if ckv_smem:
        total += _pad(2 * nl * L * hd * elem, 16)
    return total


def plan(C: int, H: int, I: int, V: int, L: int, N: int, nl: int, elem: int,
         encoder_kv_smem: bool = True) -> Plan:
    """The cluster split for a decoder of width C, H heads, FFN width I,
    vocabulary V, encoder length L, N steps, nl layers and `elem`-byte
    weights.  CL is the largest of 8, 4, 2, 1 that divides H.  Shared memory
    goes first to the block's KV cache slice (with a two-slot ring), then to
    its encoder K/V (with a four-slot ring), then to ring slots, up to
    MAX_STAGES.  encoder_kv_smem=False leaves the encoder K/V in device
    memory even where it fits (the yardstick `chip_smoke.py` times the
    shared-memory placement against)."""
    CL = next(cl for cl in (8, 4, 2, 1) if H % cl == 0)
    chunk = max(CHUNK, _pad(max(C, I) * elem, 16))

    def size(kv, ckv, stages):
        return _smem_bytes(C, H, I, V, L, N, nl, CL, elem, kv, ckv, stages, chunk)

    kv_smem = size(True, False, 2) <= SMEM_LIMIT
    ckv_smem = encoder_kv_smem and size(kv_smem, True, 4) <= SMEM_LIMIT
    stages = MAX_STAGES
    while stages > 2 and size(kv_smem, ckv_smem, stages) > SMEM_LIMIT:
        stages -= 1
    smem = size(kv_smem, ckv_smem, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K1 needs {smem} bytes of shared memory a block (limit {SMEM_LIMIT}): C={C} I={I} N={N} L={L}")
    return Plan(CL=CL, nh=H // CL, D=C // H, Vs=-(-V // CL), kv_smem=kv_smem, ckv_smem=ckv_smem, stages=stages,
                chunk=chunk, smem_bytes=smem)


@torch.no_grad()
def roformer_decode_plain(
    model,
    sampling: SamplingConfig,
    cross_kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    cross_len: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    debug_logits: bool = False,
):
    """The plain decode loop. model: `Roformer`; cross_kvs: per decoder layer
    (k, v) (B, L, H, D) from `compute_cross_kv`; cross_len (B,) valid encoder
    lengths (prefix masks).  debug_logits: also return the raw logits of
    every step, (B, N, V) f32."""
    B, L = cross_kvs[0][0].shape[:2]
    N = sampling.max_new_tokens
    device = cross_kvs[0][0].device
    caches = model.init_cache(B, N + 1, device=device)
    D = model.cfg.decoder.hidden_size // model.cfg.decoder.num_attention_heads
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import rotary_sin_cos

    tables = rotary_sin_cos(torch.arange(N + 1, device=device), D)
    mask = torch.arange(L, device=device)[None, :] < cross_len.to(device)[:, None]
    raw = []

    def step_fn(carry, token, pos):
        logits, carry = model.decode_step(token, pos, carry, None, mask, cross_kvs, tables)
        if debug_logits:
            raw.append(logits.float())
        return carry, logits

    first = torch.full((B,), sampling.bos_token_id, dtype=torch.long, device=device)
    tokens, lengths = ar_generate(
        step_fn, caches, first, model.cfg.semantic_vocab_size, sampling, generator
    )
    if debug_logits:
        return tokens, lengths, torch.stack(raw, dim=1)
    return tokens, lengths


def _decoder_modules(model) -> list:
    return [model.semantic_embed, model.dec_type_embed, model.dec_emb_ln, model.head_transform, model.head_ln,
            *model.decoder_layers]


def _weights_key(model) -> tuple:
    """Identifies the decoder-side weights as they stand: each tensor's
    storage and its version counter (bumped by every in-place update,
    `load_state_dict` and optimizer steps included).  A write through
    `p.data` (e.g. `p.data.copy_(...)`) bypasses the counter, so the packed
    copies would go stale: load weights through `load_state_dict`, or drop
    the model's entry from `_packed` after such a write."""
    params = [p for m in _decoder_modules(model) for p in m.parameters()] + [model.head_bias]
    return tuple((p.data_ptr(), p._version) for p in params) + (model.dtype,)


@torch.no_grad()
def _pack_weights(model) -> dict:
    """Kernel weights from the module's parameters (the model dtype, (out,
    in) layout; norms, embedding lookup and head bias in f32)."""
    layers = model.decoder_layers

    def ln(m):
        return torch.stack([m.weight.float(), m.bias.float()]).contiguous()

    def stack(get):
        return torch.stack([get(layer) for layer in layers]).contiguous()

    emb = model.semantic_embed.weight
    ops = dict(
        emb_eff=(emb.float() + model.dec_type_embed.weight[0].float()[None, :]).contiguous(),
        emb=emb.to(model.dtype).contiguous(),
        head_bias=model.head_bias.float().contiguous(),
        emb_ln=ln(model.dec_emb_ln),
        ht_w=model.head_transform.weight.contiguous(),
        ht_b=model.head_transform.bias.contiguous(),
        head_ln=ln(model.head_ln),
        self_ln=stack(lambda m: ln(m.self_ln)),
        cross_ln=stack(lambda m: ln(m.cross_ln)),
        ff_ln=stack(lambda m: ln(m.ff_ln)),
        ff_in_w=stack(lambda m: m.ff_in.weight),
        ff_in_b=stack(lambda m: m.ff_in.bias),
        ff_out_w=stack(lambda m: m.ff_out.weight),
        ff_out_b=stack(lambda m: m.ff_out.bias),
    )
    qkv = ("query", "key", "value")
    ops["wqkv"] = stack(lambda m: torch.stack([getattr(m.self_attn, a).weight for a in qkv]))
    ops["bqkv"] = stack(lambda m: torch.stack([getattr(m.self_attn, a).bias for a in qkv]))
    ops["wo"] = stack(lambda m: m.self_attn.out.weight)
    ops["bo"] = stack(lambda m: m.self_attn.out.bias)
    ops["cq_w"] = stack(lambda m: m.cross_attn.query.weight)
    ops["cq_b"] = stack(lambda m: m.cross_attn.query.bias)
    ops["co_w"] = stack(lambda m: m.cross_attn.out.weight)
    ops["co_b"] = stack(lambda m: m.cross_attn.out.bias)
    return ops


def _pack(model, cross_kvs, cross_len, N: int) -> dict:
    """Kernel operands: the packed weights and rotary tables, kept for the
    module between calls while its weights stay the same (`_weights_key`),
    and this call's encoder K/V and lengths."""
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import rotary_sin_cos

    C = model.cfg.decoder.hidden_size
    dev = model.head_bias.device
    key = _weights_key(model)
    cache = _packed.get(model)
    if cache is None or cache["key"] != key:
        cache = _packed[model] = dict(key=key, weights=_pack_weights(model), tables={})
    if N not in cache["tables"]:
        sin_t, cos_t = rotary_sin_cos(torch.arange(N, device=dev), C // model.cfg.decoder.num_attention_heads)
        cache["tables"][N] = dict(sin_t=sin_t.contiguous(), cos_t=cos_t.contiguous())
    return dict(
        cache["weights"],
        **cache["tables"][N],
        cross_k=torch.stack([k.reshape(k.shape[0], k.shape[1], C) for k, _ in cross_kvs]).contiguous(),
        cross_v=torch.stack([v.reshape(v.shape[0], v.shape[1], C) for _, v in cross_kvs]).contiguous(),
        cross_len=cross_len.to(device=dev, dtype=torch.int32).contiguous(),
    )


def _prepare(model, sampling: SamplingConfig, cross_kvs, cross_len: torch.Tensor,
             generator: Optional[torch.Generator], debug_logits: bool) -> Tuple[_Args, dict, Plan]:
    """Check a decode for the kernel and build its arguments: (the packed
    `_Args`, the operand tensors it points into, the cluster plan)."""
    device = model.head_bias.device
    dtype = model.dtype
    if dtype not in _FUNCS:
        raise TypeError(f"roformer_decode: model dtype {dtype} not in {list(_FUNCS)}")
    if sampling.do_sample and sampling.top_k <= 0 and sampling.top_p < 1.0:
        raise ValueError("the kernel's nucleus cutoff rides top-k; pure top-p needs the plain loop")
    if sampling.do_sample and sampling.top_k > MAX_TOP_K:
        raise ValueError(f"top_k {sampling.top_k} > {MAX_TOP_K}")
    cfg = model.cfg
    dcfg = cfg.decoder
    C, H, I = dcfg.hidden_size, dcfg.num_attention_heads, dcfg.intermediate_size
    if C % 8 or I % 8 or C > 1024 or (C // H) % 4:
        raise ValueError(f"unsupported decoder geometry C={C} H={H} I={I}")
    V = cfg.semantic_vocab_size
    N = sampling.max_new_tokens
    nl = dcfg.num_hidden_layers
    B, L = cross_kvs[0][0].shape[:2]
    if cross_kvs[0][0].dtype != dtype:
        raise TypeError("cross K/V must be in the model dtype")
    lo, hi = (int(x) for x in torch.aminmax(cross_len))
    if cross_len.shape != (B,) or lo < 1 or hi > L:
        raise ValueError(f"cross_len must be (B,) = ({B},) in [1, {L}]: got {cross_len.tolist()}")
    p = plan(C, H, I, V, L, N, nl, torch.empty((), dtype=dtype).element_size())

    if sampling.do_sample:
        gen_dev = generator.device if generator is not None else "cpu"
        seed = torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev).to(device)
    else:
        seed = torch.zeros((1,), dtype=torch.int64, device=device)
    ops = _pack(model, cross_kvs, cross_len, N)
    ops["seed"] = seed
    if not p.kv_smem:
        ops["kv_cache"] = torch.empty((B, p.CL, 2, nl, p.nh, N, p.D), dtype=dtype, device=device)
    ops["tokens"] = torch.empty((B, N), dtype=torch.int32, device=device)
    ops["lengths"] = torch.empty((B,), dtype=torch.int32, device=device)
    if debug_logits:
        ops["debug_logits"] = torch.empty((B, N, V), dtype=torch.float32, device=device)
    for name, t in ops.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"operand {name} must be contiguous on {device}")

    args = _Args()
    for name in _POINTERS:
        setattr(args, name, ops[name].data_ptr() if name in ops else None)
    ints = dict(
        B=B, C=C, H=H, I=I, V=V, L=L, N=N, nl=nl,
        do_sample=int(sampling.do_sample), top_k=int(sampling.top_k) if sampling.do_sample else 0,
        use_end_gate=int(sampling.end_gate_threshold is not None),
        eos=sampling.eos_token_id, pad=sampling.pad_token_id, bos=sampling.bos_token_id,
        ban_until=sampling.ban_until,
        CL=p.CL, nh=p.nh, Vs=p.Vs, kv_smem=int(p.kv_smem), ckv_smem=int(p.ckv_smem), stages=p.stages, chunk=p.chunk,
        smem_bytes=p.smem_bytes,
    )
    floats = dict(
        eps=dcfg.layer_norm_eps, scale=(C // H) ** -0.5, temperature=sampling.temperature,
        top_p=sampling.top_p, repetition_penalty=sampling.repetition_penalty,
        end_gate=sampling.end_gate_threshold if sampling.end_gate_threshold is not None else 0.0,
    )
    for name, val in {**ints, **floats}.items():
        setattr(args, name, val)
    return args, ops, p


def _check_device(model) -> torch.device:
    device = model.head_bias.device
    if device.type != "cuda":
        raise RuntimeError(f"roformer_decode: no kernel for device {device}")
    return device


@torch.no_grad()
def roformer_decode(
    model,
    sampling: SamplingConfig,
    cross_kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    cross_len: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    debug_logits: bool = False,
):
    """Whole AR decode: the K1 kernel for a model on the card, the plain
    loop for a model on the CPU (same signature and returns as
    `roformer_decode_plain`)."""
    global launches
    if model.head_bias.device.type == "cpu":
        return roformer_decode_plain(model, sampling, cross_kvs, cross_len, generator, debug_logits)
    device = _check_device(model)
    args, ops, _ = _prepare(model, sampling, cross_kvs, cross_len, generator, debug_logits)
    fn = build.entry(_FUNCS[model.dtype], _ARGTYPES)
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ar_decode launch failed: cudaError {err}")
    launches += 1
    if debug_logits:
        return ops["tokens"], ops["lengths"], ops["debug_logits"]
    return ops["tokens"], ops["lengths"]


@torch.no_grad()
def max_active_clusters(model, sampling: SamplingConfig, cross_kvs, cross_len) -> Tuple[Plan, int]:
    """(the plan of this decode, cudaOccupancyMaxActiveClusters for its
    launch: how many of its clusters the card holds at once)."""
    device = _check_device(model)
    args, _, p = _prepare(model, sampling, cross_kvs, cross_len, None, False)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.entry(_CLUSTERS[model.dtype], _ARGTYPES)(ctypes.addressof(args), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ar_decode occupancy query failed: cudaError {err}")
    return p, out.value
