"""Chip smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `latent_diffusion_speech_tpu_torch/csrc`
with nvcc (sm_90a), then:

1. holds each kernel against its plain PyTorch version on the card at the
   shapes the serve path gives it (K4 attention_fwd at the four UNet
   resolutions and T=1024; K1 ar_decode at the flagship decoder width,
   B in {1, 4}, N=430; the fused UNet forward unet_fwd (K2/K3) at the
   flagship width, T in {64, 448, 1024}, f32 and bf16), and times each
   beside its plain version, its bound and, where one exists, the one
   PyTorch call that computes the same function;
2. drives the port's serve path once at flagship width with seeded random
   weights (bf16): one `TTSPipeline.tts` and one `tts_batch` of 4 English
   requests, with per-stage wall times, and shows through the kernels'
   launch counters that the path ran through K1 and K4;
3. drives the same path in the fused configuration
   (`Unit2MelSystem(unet_impl="pallas")`, the same weights): one `tts`
   (20 unet_fwd launches, no K4) and one `tts_batch` of 4 (B>1 stays on the
   eager module: K4, no unet_fwd), with its stage times beside the eager
   ones;
4. checks the 20-step diffusion + vocoder against the same run with the
   plain attention, in f32, on a short input, and the fused configuration's
   diffusion trajectory against the eager one (bf16 and f32, same x_init).

Any failure raises (exit code != 0).  The second-to-last line is a JSON
object with one entry per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_TOKENS = 430  # ~5 s of 44.1 kHz audio at hop 512
TEXT = "The quick brown fox jumps over the lazy dog, and then it runs back home."
BATCH_TEXTS = [
    "Hello world, this is a test of the speech system.",
    "Good morning.",
    "Please read the following sentence slowly and clearly.",
    "How are you today?",
]
# K4 shapes on the serve path: (T, D) at H=8 for the four UNet resolutions
# of a 448-frame bucket, plus the T=1024 bucket of max_length=1024
K4_SHAPES = [(448, 32), (224, 48), (112, 64), (56, 64), (1024, 64)]
# fused UNet buckets: the smallest, the 430-token one, max_length=1024
UNET_T = (64, 448, 1024)
# H100 SXM peaks (NVIDIA datasheet, dense): HBM bytes/s, bf16 tensor FLOP/s
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def bound(bytes_moved: float, flops: float) -> tuple:
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_b, t_f = bytes_moved / HBM_BPS, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k4(dev) -> dict:
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    rows = []
    for T, D in K4_SHAPES:
        q, k, v = (torch.randn((1, T, 8, D), generator=gen, device=dev) for _ in range(3))
        # f32: the kernel's arithmetic against the plain version
        out, lse = k4.fused_attention_with_lse(q, k, v)
        ref, ref_lse = k4.fused_attention_plain(q, k, v)
        torch.cuda.synchronize()
        e32 = (out - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if e32 > 2e-5 or lse_err > 1e-4:
            raise AssertionError(f"K4 f32 T={T} D={D}: out err {e32}, lse err {lse_err} (atol 2e-5 / 1e-4)")
        # bf16 (the serve dtype) against the f32 plain version on the same
        # bf16-rounded inputs; atol/rtol 3e-2 as tests/test_pallas.py holds
        # the TPU kernel's bf16 output to its f32 reference
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        outb = k4.fused_attention(qb, kb, vb)
        refb, _ = k4.fused_attention_plain(qb.float(), kb.float(), vb.float())
        torch.cuda.synchronize()
        err = (outb.float() - refb).abs()
        if not bool((err <= 3e-2 + 3e-2 * refb.abs()).all()):
            raise AssertionError(f"K4 bf16 T={T} D={D}: max err {err.max().item()} over atol/rtol 3e-2")
        worst = max(worst, err.max().item())
        ms = cuda_time_ms(lambda: k4.fused_attention(qb, kb, vb), iters=50)
        plain_ms = cuda_time_ms(lambda: k4.fused_attention_plain(qb, kb, vb), iters=50)
        rows.append((T, D, ms, plain_ms))
        print(f"K4 attention_fwd T={T} H=8 D={D}: f32 err {e32:.2e} lse err {lse_err:.2e}; "
              f"bf16 vs f32 plain max err {err.max().item():.3e}; "
              f"kernel {ms * 1e3:.1f} us/call, plain {plain_ms * 1e3:.1f} us/call")
    T, D, ms, plain_ms = rows[0]
    # yardstick only (the port never calls it): PyTorch's fused attention at
    # the timed shape; bound: q, k, v read and out, lse written once, and
    # q.k and p.v (2 * 2 * T * T * D per head)
    q, k, v = (torch.randn((1, 8, T, D), generator=gen, device=dev).bfloat16() for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(q, k, v), iters=50)
    bound_ms, bound_by = bound(4 * T * 8 * D * 2 + 8 * T * 4, 4 * T * T * 8 * D)
    print(f"K4 at T={T} D={D}: bound {bound_ms * 1e3:.2f} us ({bound_by}), "
          f"F.scaled_dot_product_attention {library_ms * 1e3:.1f} us")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, rows=rows, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_k1(dev) -> dict:
    import torch

    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem
    from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1

    cfg = RoformerConfig()
    rng = np.random.default_rng(0)
    L = 48
    phones = rng.integers(1, 100, (4, L))
    tones = rng.integers(0, 10, (4, L))
    mask = np.ones((4, L), np.int64)
    mask[1, 30:] = 0
    mask[3, 17:] = 0

    def prepare(lm, B):
        m = lm.module
        with torch.no_grad():
            enc = m.encode(*(torch.as_tensor(a[:B], device=dev) for a in (phones, tones, np.ones_like(phones), mask)))
            kvs = m.compute_cross_kv(enc)
        return m, kvs, torch.as_tensor(mask[:B].sum(-1), dtype=torch.int32, device=dev)

    def sampling(do_sample):
        return SamplingConfig(max_new_tokens=N_TOKENS, do_sample=do_sample, eos_token_id=cfg.semantic_eos,
                              pad_token_id=cfg.semantic_pad, bos_token_id=cfg.semantic_bos)

    out = {}
    # f32 greedy: tokens and lengths identical
    lm32 = RoformerSystem(cfg, dtype=torch.float32, device=dev, seed=0)
    for B in (1, 4):
        m, kvs, clen = prepare(lm32, B)
        got = k1.roformer_decode(m, sampling(False), kvs, clen)
        ref = k1.roformer_decode_plain(m, sampling(False), kvs, clen)
        for g, r, what in zip(got, ref, ("tokens", "lengths")):
            if not torch.equal(g.cpu(), r.cpu()):
                bad = (g.cpu() != r.cpu()).nonzero()[:5].tolist()
                raise AssertionError(f"K1 f32 greedy B={B}: {what} differ at {bad}")
        print(f"K1 ar_decode f32 greedy B={B} N={N_TOKENS}: tokens and lengths identical "
              f"(lengths {got[1].tolist()})")

    # bf16 greedy: the raw logits (debug-logits path) close at every step
    # whose inputs agree, i.e. up to and including the first step at which
    # a rounding flips an argmax; sampled tokens in the processed top-k/top-p
    # support of the kernel's own logits
    lm16 = RoformerSystem(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    m, kvs, clen = prepare(lm16, 4)
    toks_k, _, lg = k1.roformer_decode(m, sampling(False), kvs, clen, debug_logits=True)
    toks_p, _, lg_ref = k1.roformer_decode_plain(m, sampling(False), kvs, clen, debug_logits=True)
    differ = (toks_k != toks_p).any(dim=0).nonzero()
    n_cmp = int(differ[0]) + 1 if len(differ) else N_TOKENS
    a, b = lg[:, :n_cmp], lg_ref[:, :n_cmp]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    corr = float(np.corrcoef(a.flatten().cpu().numpy(), b.flatten().cpu().numpy())[0, 1])
    # 2% of the logits' scale: a few bf16 roundings of C=256 sums apart
    if err > 0.02 * scale or corr < 0.9999:
        raise AssertionError(f"K1 bf16 logits over {n_cmp} steps: max err {err} (scale {scale}), corr {corr}")
    print(f"K1 ar_decode bf16 greedy B=4: logits of the first {n_cmp} steps (tokens agree before "
          f"the last): max abs err {err:.3e} (scale {scale:.2f}, tolerance 2% of scale), "
          f"corr {corr:.6f}")

    sc = sampling(True)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks, lens, lg = k1.roformer_decode(m, sc, kvs, clen, generator=gen, debug_logits=True)
    V = cfg.semantic_vocab_size
    rep = torch.zeros((4, V), dtype=torch.bool, device=dev)
    rep[:, cfg.semantic_bos] = True
    for pos in range(N_TOKENS):
        live = pos < lens
        processed = process_logits(lg[:, pos], rep, sc)
        cur = toks[:, pos].long()
        chosen = processed.gather(1, cur[:, None])[:, 0]
        if not bool(torch.isfinite(chosen[live]).all()):
            raise AssertionError(f"K1 sampled token outside the top-k/top-p support at step {pos}")
        if not bool((cur[~live] == cfg.semantic_pad).all()):
            raise AssertionError(f"K1: non-PAD token after EOS at step {pos}")
        rep[torch.arange(4, device=dev), cur] = True
    print(f"K1 ar_decode bf16 sampled (top_k=5, top_p=0.8, rep 1.2) B=4: all tokens within "
          f"the processed support (lengths {lens.tolist()})")
    out["max_abs_err"] = err

    # timing at the serve setting (bf16, sampled), per generated token
    for B in (1, 4):
        m, kvs, clen = prepare(lm16, B)
        t_k = cuda_time_ms(lambda: k1.roformer_decode(m, sc, kvs, clen, generator=gen), iters=5, warmup=1)
        t_p = cuda_time_ms(lambda: k1.roformer_decode_plain(m, sc, kvs, clen, generator=gen), iters=2, warmup=1)
        n = int(k1.roformer_decode(m, sc, kvs, clen, generator=gen)[1].max())
        print(f"K1 ar_decode bf16 B={B}: kernel {t_k:.2f} ms ({t_k * 1e3 / N_TOKENS:.1f} us/step), "
              f"plain {t_p:.2f} ms ({t_p * 1e3 / N_TOKENS:.1f} us/step); {N_TOKENS} steps, "
              f"longest stream {n} tokens")
        if B == 1:
            out.update(ms=t_k, plain_ms=t_p)
            out["bound_ms"], out["bound_by"] = k1_bound(m, kvs, cfg, B, n)
            print(f"K1 at B=1: bound {out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}) for {n} steps; "
                  "no single PyTorch call computes a whole decode")
    return out


def k1_bound(m, kvs, cfg, B: int, steps: int) -> tuple:
    """Bound of one whole decode: the decoder-side parameters and the cross
    K/V read once, tokens and lengths written once; per generated token
    the decoder layer's products (self q/k/v/o, cross q/o, the FFN), the
    head transform and the tied head, and attention over the cache and the
    encoder rows."""
    dec = [p for n, p in m.named_parameters() if not n.startswith(("enc", "phone_", "tone_", "spk_"))]
    bytes_in = sum(p.numel() * p.element_size() for p in dec)
    bytes_in += sum(k.numel() * k.element_size() + v.numel() * v.element_size() for k, v in kvs)
    bytes_out = B * steps * 4 + B * 4
    C, I, V = cfg.decoder.hidden_size, cfg.decoder.intermediate_size, cfg.semantic_vocab_size
    L = kvs[0][0].shape[1]
    layers = cfg.decoder.num_hidden_layers
    macs = 0
    for pos in range(1, steps + 1):
        macs += layers * (6 * C * C + 2 * C * I + 2 * pos * C + 2 * L * C) + C * C + V * C
    return bound(bytes_in + bytes_out, 2 * B * macs)


def check_unet(dev) -> dict:
    """The fused UNet forward (K2/K3) at the flagship width, seeded random
    weights: f32 kernel against the f32 plain version (max error <= 1e-3 of
    the output's scale: f32 sums in another order, and atomic split-K sums);
    bf16 kernel against the f32 plain version on the same bf16-rounded
    weights and inputs under the K2/K3 contract (tests/test_pallas_unet.py):
    corr > 0.999, max error <= max(4 x the bf16 plain version's own error,
    2% of scale).  Times kernel, plain version and the eager UNet1D.forward
    it replaces (bf16), beside the bound."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
    from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded

    cfg = UNet1DConfig()
    m32 = seeded(lambda: UNet1D(cfg), 0).to(dev).eval()
    m16 = cast_compute_dtype(copy.deepcopy(m32), torch.bfloat16)
    m32r = cast_compute_dtype(copy.deepcopy(m16), torch.float32)
    p32, p16, p32r = (k23.pack_unet_params(m, cfg) for m in (m32, m16, m32r))
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.tensor([437.0], device=dev)
    rows, worst = {}, 0.0
    with torch.no_grad():
        for T in UNET_T:
            x = torch.randn((1, T, cfg.in_channels), generator=gen, device=dev)
            got = k23.unet_fwd(p32, x, t, cfg)
            ref = k23.unet_fwd_plain(p32, x, t, cfg)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            e32 = (got - ref).abs().max().item()
            if not bool(torch.isfinite(got).all()) or e32 > 1e-3 * scale:
                raise AssertionError(f"unet_fwd f32 T={T}: max err {e32} (scale {scale}, tolerance 1e-3 of scale)")
            xb = x.bfloat16()
            gotb = k23.unet_fwd(p16, xb, t, cfg).float()
            plainb = k23.unet_fwd_plain(p16, xb, t, cfg).float()
            ref32 = k23.unet_fwd_plain(p32r, xb.float(), t, cfg)
            torch.cuda.synchronize()
            err = (gotb - ref32).abs().max().item()
            limit = max(4 * (plainb - ref32).abs().max().item(), 0.02 * ref32.abs().max().item())
            corr = torch.corrcoef(torch.stack([gotb.flatten(), ref32.flatten()]))[0, 1].item()
            if err > limit or corr <= 0.999:
                raise AssertionError(f"unet_fwd bf16 T={T}: max err {err} (limit {limit}), corr {corr}")
            worst = max(worst, err)
            ms = cuda_time_ms(lambda: k23.unet_fwd(p16, xb, t, cfg), iters=10, warmup=2)
            ms32 = cuda_time_ms(lambda: k23.unet_fwd(p32, x, t, cfg), iters=10, warmup=2)
            plain_ms = cuda_time_ms(lambda: k23.unet_fwd_plain(p16, xb, t, cfg), iters=3, warmup=1)
            eager_ms = cuda_time_ms(lambda: m16(xb, t), iters=5, warmup=2)
            # inputs read once (packed weights and f32 params, the scale/shift
            # row, x), the output written once; operations of the op table
            moved = (p16.weights.numel() * 2 + p16.params.numel() * 4 + k23._scale_shift(p16, t).numel() * 2
                     + xb.numel() * 2 + gotb.numel() * 2)
            bound_ms, bound_by = bound(moved, k23.unet_flops(p16, T))
            rows[T] = dict(ms=ms, plain_ms=plain_ms, eager_ms=eager_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"unet_fwd T={T}: f32 err {e32:.2e} (scale {scale:.3f}); bf16 vs f32 plain max err {err:.3e} "
                  f"(limit {limit:.3e}), corr {corr:.6f}; kernel {ms * 1e3:.1f} us (f32 kernel {ms32 * 1e3:.1f} us), "
                  f"plain {plain_ms * 1e3:.1f} us, "
                  f"eager UNet1D.forward {eager_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}, "
                  f"{moved / 1e6:.1f} MB, {k23.unet_flops(p16, T) / 1e9:.2f} GFLOP); grid {k23.launch_info}")
            if T == 448:
                phase_breakdown(k23, p16, xb, t, cfg)
    return dict(max_abs_err=worst, rows=rows, **rows[448])


def phase_breakdown(k23, packed, x, t, cfg):
    """Where one fused forward's time goes: the GPU clock after every grid
    barrier, summed by the kind of record(s) in each phase."""
    import torch

    T = x.shape[1]
    table = k23._table(packed, T)
    ns = torch.zeros(table.phases + 1, dtype=torch.int64, device=x.device)
    for _ in range(3):
        k23.unet_fwd(packed, x, t, cfg, phase_ns=ns)
    torch.cuda.synchronize()
    d = (ns[1:] - ns[:-1]).tolist()
    f = {n: i for i, n in enumerate(k23.FIELDS)}
    pro = {k23.PRO_NONE: "plain", k23.PRO_GN: "GroupNorm", k23.PRO_LN: "LayerNorm", k23.PRO_GEGLU: "GEGLU"}
    sums, phase, kinds = {}, 0, []
    for r in table.records.tolist():
        if r[f["KIND"]] == k23.KIND_ATTN:
            kinds.append("attention")
        else:
            kinds.append(f"GEMM {pro[r[f['PRO']]]} k={r[f['TAPS']]}")
        if r[f["SYNC"]]:
            key = " + ".join(kinds)
            s = sums.setdefault(key, [0, 0])
            s[0] += d[phase]
            s[1] += 1
            phase, kinds = phase + 1, []
    print(f"unet_fwd T={T} bf16 phases: {table.phases} barriers, {sum(d) / 1e6:.3f} ms between the first "
          "and the last")
    for key, (s, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"  {key}: {s / 1e3:.1f} us over {n} phases ({s / n / 1e3:.1f} us each)")


def build_pipeline(dev, dtype, seed=0):
    import torch

    from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

    codebook = np.random.default_rng(seed).standard_normal((4096, 1280)).astype(np.float32)
    return TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(attn_impl="fused"), dtype=dtype, device=dev, seed=seed),
        Vocoder("hifi-vaegan", VAEGANConfig(), dtype=dtype, device=dev, seed=seed),
        lm=RoformerSystem(RoformerConfig(), dtype=dtype, device=dev, seed=seed),
        codebook=codebook,
    )


def timed(stages: dict, name: str, fn):
    """Wrap fn so each call adds its synchronised wall time to stages[name]."""
    import torch

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        stages[name + "_calls"] = stages.get(name + "_calls", 0) + 1
        return out

    return wrapper


def fused_pipeline(pipe, dev, dtype, seed=0):
    """`pipe` with its Unit2Mel in the fused configuration (the same seed,
    so the same weights)."""
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem

    fused = copy.copy(pipe)
    fused.diffusion = Unit2MelSystem(Unit2MelConfig(attn_impl="fused"), dtype=dtype, device=dev, seed=seed,
                                     unet_impl="pallas")
    return fused


def serve(dev, card: str) -> dict:
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    pipe = build_pipeline(dev, torch.bfloat16)
    K = pipe.lm.cfg.semantic_kmeans_num
    hop = pipe.vocoder.vocoder_hop_size
    stages: dict = {}
    generated = []

    def generate(*a, **kw):
        toks, lens = real_generate(*a, **kw)
        generated.append((toks.cpu().numpy(), lens.cpu().numpy()))
        return toks, lens

    real_generate = pipe.lm.generate
    pipe.lm.generate = timed(stages, "lm_decode", generate)
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.vocoder.infer = timed(stages, "vocoder", pipe.vocoder.infer)

    # warm-up request (cuDNN autotuning, allocator), not counted
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    stages.clear()
    generated.clear()

    k1.launches = 0
    k4.launches = 0
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    diff_tts = stages["diffusion_20step"]
    k1_after_tts, k4_after_tts = k1.launches, k4.launches
    t0 = time.perf_counter()
    outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
    t_batch = time.perf_counter() - t0
    launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches}

    # each generate call ran K1 once; each diffusion call ran K4 640 times
    # (20 denoiser evaluations x 32 self-attention calls)
    n_gen = stages["lm_decode_calls"]
    n_inf = stages["diffusion_20step_calls"]
    if k1_after_tts != 1 or launches["ar_decode"] != n_gen or n_gen != 2:
        raise AssertionError(f"K1 launches {k1_after_tts} / {launches['ar_decode']} for {n_gen} generate calls")
    if k4_after_tts != 640 or launches["attention_fwd"] != 640 * n_inf:
        raise AssertionError(f"K4 launches {k4_after_tts} / {launches['attention_fwd']} for {n_inf} infer calls")

    def n_tokens(toks, lens, b):
        t = toks[b, : lens[b]]
        return int((t < K).sum())

    results = [(wav, sr, n_tokens(*generated[0], 0))]
    results += [(w, s, n_tokens(*generated[1], b)) for b, (w, s) in enumerate(outs)]
    for w, s, n in results:
        if s != 44100 or w.ndim != 1 or len(w) != n * hop or not np.isfinite(w).all() or n == 0:
            raise AssertionError(f"bad output: sr {s}, shape {w.shape}, tokens {n}")
    print(f"serve tts: {len(wav) / sr:.3f} s of audio ({results[0][2]} tokens) in {t_tts:.3f} s; "
          f"tts_batch x4: {[round(len(w) / s, 3) for w, s, _ in results[1:]]} s in {t_batch:.3f} s")
    for name in ("lm_decode", "diffusion_20step", "vocoder"):
        print(f"stage {name}: {stages[name]:.4f} s over {stages[name + '_calls']} calls "
              f"(tts + tts_batch) [{card}]")
    print(f"launches in the serve run: {launches} ({n_gen} generate, {n_inf} diffusion calls)")
    print(f"20-step diffusion of the tts (B=1): {diff_tts:.4f} s [{card}]")
    return dict(launches=launches, stages=stages, pipe=pipe, t_tts=t_tts, diff_tts=diff_tts)


def serve_fused(dev, card: str, eager: dict) -> int:
    """The serve path in the fused configuration: `tts` sends its 20
    denoiser forwards through unet_fwd (and no K4); `tts_batch` of 4 keeps
    B>1 on the eager module (K4, no unet_fwd)."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23

    pipe = fused_pipeline(eager["pipe"], dev, torch.bfloat16)
    hop = pipe.vocoder.vocoder_hop_size
    stages: dict = {}
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)  # warm-up
    stages.clear()

    k1.launches = k4.launches = k23.launches = 0
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    tts_launches = {"unet_fwd": k23.launches, "attention_fwd": k4.launches}
    diff_tts = stages["diffusion_20step"]
    if tts_launches != {"unet_fwd": 20, "attention_fwd": 0}:
        raise AssertionError(f"fused tts: launches {tts_launches}, want 20 unet_fwd and 0 attention_fwd")
    n = len(wav) // hop
    if sr != 44100 or wav.ndim != 1 or n == 0 or len(wav) != n * hop or not np.isfinite(wav).all():
        raise AssertionError(f"fused tts: bad output: sr {sr}, shape {wav.shape}")
    t0 = time.perf_counter()
    outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
    t_batch = time.perf_counter() - t0
    n_batch_inf = stages["diffusion_20step_calls"] - 1
    if k23.launches != 20 or k4.launches != 640 * n_batch_inf:
        raise AssertionError(f"fused tts_batch: unet_fwd {k23.launches - 20} (want 0), attention_fwd "
                             f"{k4.launches} (want {640 * n_batch_inf})")
    for w, s in outs:
        if s != 44100 or w.ndim != 1 or len(w) == 0 or not np.isfinite(w).all():
            raise AssertionError(f"fused tts_batch: bad output: sr {s}, shape {w.shape}")
    e = eager["stages"]
    print(f"fused serve tts: {len(wav) / sr:.3f} s of audio in {t_tts:.3f} s (eager {eager['t_tts']:.3f} s); "
          f"20-step diffusion of the tts {diff_tts:.4f} s (eager {eager['diff_tts']:.4f} s); launches "
          f"{tts_launches} [{card}]")
    print(f"fused serve tts_batch x4: {t_batch:.3f} s (B>1: eager module; unet_fwd +0, attention_fwd "
          f"+{k4.launches} over {n_batch_inf} infer calls); diffusion stage over both calls "
          f"{stages['diffusion_20step']:.4f} s vs eager {e['diffusion_20step']:.4f} s [{card}]")
    return k23.launches


def check_trajectory(dev):
    """The fused configuration's 20-step diffusion (inside `pipe.infer`, 430
    tokens -> the 448-frame bucket) against the eager one from the same
    x_init: bf16 under the JAX wiring contract (tests/test_pallas_unet.py:
    corr > 0.99, max |a-b| < 0.15 max(|a|, 1)); f32 at atol/rtol 2e-3 (the
    sampler tolerance of tests/test_diffusion.py)."""
    import torch

    for dtype in (torch.bfloat16, torch.float32):
        eager = build_pipeline(dev, dtype)
        fused = fused_pipeline(eager, dev, dtype)
        units = eager.semantic_to_units(np.arange(N_TOKENS) * 7 % 4096)
        x_init = torch.randn((1, 448, 128), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        mels, wavs = [], []
        for pipe in (eager, fused):
            real = pipe.diffusion.infer
            pipe.diffusion.infer = lambda *a, _real=real, **kw: mels.append(_real(*a, **kw)) or mels[-1]
            wavs.append(pipe.infer(units, spk_id=2, x_init=x_init).float())
        a, b = (m.float() for m in mels)
        err = (a - b).abs().max().item()
        corr = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1].item()
        if dtype == torch.bfloat16:
            ok = corr > 0.99 and err < 0.15 * max(a.abs().max().item(), 1.0)
        else:
            ok = bool(((a - b).abs() <= 2e-3 + 2e-3 * a.abs()).all())
        if not ok:
            raise AssertionError(f"fused vs eager trajectory {dtype}: max err {err}, corr {corr}")
        print(f"trajectory {str(dtype)[6:]} fused vs eager (20 steps, T=448, same x_init): mel max err "
              f"{err:.3e} (scale {a.abs().max().item():.3f}), corr {corr:.6f}; wav max err "
              f"{(wavs[0] - wavs[1]).abs().max().item():.3e}")


def check_slice_against_plain(dev):
    """20-step diffusion + vocoder with the K4 kernel against the same run
    with the plain attention, f32, same units and x_init (sampler
    tolerance atol/rtol 2e-3, tests/test_diffusion.py)."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    pipe = build_pipeline(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    units = pipe.semantic_to_units(np.arange(50) * 7 % 4096)
    x_init = torch.randn((1, 64, 128), generator=gen, device=dev)
    got = pipe.infer(units, spk_id=2, x_init=x_init)
    unet1d.fused_attention = lambda q, k, v: k4.fused_attention_plain(q, k, v)[0]
    try:
        ref = pipe.infer(units, spk_id=2, x_init=x_init)
    finally:
        unet1d.fused_attention = k4.fused_attention
    err = (got - ref).abs().max().item()
    if not bool(((got - ref).abs() <= 2e-3 + 2e-3 * ref.abs()).all()):
        raise AssertionError(f"slice f32 wav kernel vs plain attention: max err {err}")
    print(f"slice f32 (50 tokens, 20 steps + vocoder) with K4 vs plain attention: max wav err {err:.2e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import build_info, load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    print(f"capability: {cap}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; this card is {cap}")
    t0 = time.perf_counter()
    load_library()
    info = build_info()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())

    k4 = check_k4(dev)
    k1 = check_k1(dev)
    k23 = check_unet(dev)
    eager = serve(dev, card)
    launches = eager["launches"]
    launches["unet_fwd"] = serve_fused(dev, card, eager)
    del eager
    check_slice_against_plain(dev)
    check_trajectory(dev)

    src = "latent_diffusion_speech_tpu_torch/csrc/"
    kernels = [
        dict(name="ar_decode", route="cuda", source=src + "ar_decode.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/ar_decode.py:374",
             launches=launches["ar_decode"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
             library_ms=None),
        dict(name="attention_fwd", route="cuda", source=src + "attention_fwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/fused_attention.py:127",
             launches=launches["attention_fwd"], max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=k4["library_ms"]),
        dict(name="unet_fwd", route="cuda", source=src + "unet_fwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/unet1d_fused.py:712 + "
                      "latent_diffusion_speech_tpu/ops/pallas/unet1d_stream.py:519",
             launches=launches["unet_fwd"], max_abs_err=k23["max_abs_err"],
             ms=k23["ms"], plain_ms=k23["plain_ms"], bound_ms=k23["bound_ms"], bound_by=k23["bound_by"],
             library_ms=None),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
