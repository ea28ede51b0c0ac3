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
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, ar_generate

__all__ = ["roformer_decode", "roformer_decode_plain", "MAX_TOP_K"]

MAX_TOP_K = 64
_FUNCS = {torch.bfloat16: "ar_decode_bf16", torch.float32: "ar_decode_f32"}

# kernel launches since the last reset (chip_smoke.py resets and reads it)
launches = 0

_POINTERS = (
    "emb_eff emb head_bias sin_t cos_t emb_ln ht_w ht_b head_ln "
    "wq bq wk bk wv bv wo bo self_ln cq_w cq_b co_w co_b cross_ln "
    "ff_in_w ff_in_b ff_out_w ff_out_b ff_ln cross_k cross_v cross_len "
    "k_cache v_cache rep tokens lengths debug_logits"
).split()
_INTS = "B C H I V L N nl do_sample top_k use_end_gate eos pad bos ban_until".split()
_FLOATS = "eps scale temperature top_p repetition_penalty end_gate".split()


class _Args(ctypes.Structure):
    """Mirror of `struct ArDecodeArgs` in csrc/ar_decode.cu (same order)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in _POINTERS]
        + [("seed", ctypes.c_uint64)]
        + [(n, ctypes.c_int) for n in _INTS]
        + [(n, ctypes.c_float) for n in _FLOATS]
    )


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


def _pack(model, cross_kvs, cross_len, N: int) -> dict:
    """Kernel operands from the module's parameters (weights in the model
    dtype, (out, in) layout; norms, embedding lookup and head bias in f32)."""
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import rotary_sin_cos

    cfg = model.cfg
    C = cfg.decoder.hidden_size
    H = cfg.decoder.num_attention_heads
    layers = model.decoder_layers
    dev = model.head_bias.device

    def ln(m):
        return torch.stack([m.weight.float(), m.bias.float()]).contiguous()

    def stack(get):
        return torch.stack([get(layer) for layer in layers]).contiguous()

    emb = model.semantic_embed.weight
    sin_t, cos_t = rotary_sin_cos(torch.arange(N, device=dev), C // H)
    ops = dict(
        emb_eff=(emb.float() + model.dec_type_embed.weight[0].float()[None, :]).contiguous(),
        emb=emb.to(model.dtype).contiguous(),
        head_bias=model.head_bias.float().contiguous(),
        sin_t=sin_t.contiguous(),
        cos_t=cos_t.contiguous(),
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
        cross_k=torch.stack([k.reshape(k.shape[0], k.shape[1], C) for k, _ in cross_kvs]).contiguous(),
        cross_v=torch.stack([v.reshape(v.shape[0], v.shape[1], C) for _, v in cross_kvs]).contiguous(),
        cross_len=cross_len.to(device=dev, dtype=torch.int32).contiguous(),
    )
    for name, attr in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
        ops["w" + name] = stack(lambda m: getattr(m.self_attn, attr).weight)
        ops["b" + name] = stack(lambda m: getattr(m.self_attn, attr).bias)
    ops["cq_w"] = stack(lambda m: m.cross_attn.query.weight)
    ops["cq_b"] = stack(lambda m: m.cross_attn.query.bias)
    ops["co_w"] = stack(lambda m: m.cross_attn.out.weight)
    ops["co_b"] = stack(lambda m: m.cross_attn.out.bias)
    return ops


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
    device = model.head_bias.device
    if device.type == "cpu":
        return roformer_decode_plain(model, sampling, cross_kvs, cross_len, generator, debug_logits)
    if device.type != "cuda":
        raise RuntimeError(f"roformer_decode: no kernel for device {device}")
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

    seed = 0
    if sampling.do_sample:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device if generator is not None else "cpu"))

    ops = _pack(model, cross_kvs, cross_len, N)
    ops["k_cache"] = torch.empty((nl, B, N, C), dtype=torch.float32, device=device)
    ops["v_cache"] = torch.empty((nl, B, N, C), dtype=torch.float32, device=device)
    ops["rep"] = torch.empty((B, V), dtype=torch.uint8, device=device)
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
    args.seed = seed
    ints = dict(
        B=B, C=C, H=H, I=I, V=V, L=L, N=N, nl=nl,
        do_sample=int(sampling.do_sample), top_k=int(sampling.top_k) if sampling.do_sample else 0,
        use_end_gate=int(sampling.end_gate_threshold is not None),
        eos=sampling.eos_token_id, pad=sampling.pad_token_id, bos=sampling.bos_token_id,
        ban_until=sampling.ban_until,
    )
    floats = dict(
        eps=dcfg.layer_norm_eps, scale=(C // H) ** -0.5, temperature=sampling.temperature,
        top_p=sampling.top_p, repetition_penalty=sampling.repetition_penalty,
        end_gate=sampling.end_gate_threshold if sampling.end_gate_threshold is not None else 0.0,
    )
    for name, val in {**ints, **floats}.items():
        setattr(args, name, val)

    from latent_diffusion_speech_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    lib.ar_decode_args_size.restype = ctypes.c_int
    lib.ar_decode_args_size.argtypes = []
    if lib.ar_decode_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("ArDecodeArgs layout differs between csrc/ar_decode.cu and the wrapper")
    fn = getattr(lib, _FUNCS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ar_decode launch failed: cudaError {err}")
    launches += 1
    if debug_logits:
        return ops["tokens"], ops["lengths"], ops["debug_logits"]
    return ops["tokens"], ops["lengths"]
