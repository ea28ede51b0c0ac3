"""Chip smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `latent_diffusion_speech_tpu_torch/csrc`
with nvcc (sm_90a), then:

1. holds each kernel against its plain PyTorch version on the card at the
   shapes the serve path gives it (K4 attention_fwd at the four UNet
   resolutions and T=1024; K1 ar_decode at the flagship decoder width,
   B in {1, 4}, N=430), and times both;
2. drives the port's serve path once at flagship width with seeded random
   weights (bf16): one `TTSPipeline.tts` and one `tts_batch` of 4 English
   requests, with per-stage wall times, and shows through the kernels'
   launch counters that the path ran through both kernels;
3. checks the 20-step diffusion + vocoder against the same run with the
   plain attention, in f32, on a short input.

Any failure raises (exit code != 0).  The second-to-last line is a JSON
object with one entry per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

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
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, rows=rows)


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
    return out


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
    return launches


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
    launches = serve(dev, card)
    check_slice_against_plain(dev)

    src = "latent_diffusion_speech_tpu_torch/csrc/"
    kernels = [
        dict(name="ar_decode", route="cuda", source=src + "ar_decode.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/ar_decode.py:374",
             launches=launches["ar_decode"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="attention_fwd", route="cuda", source=src + "attention_fwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/fused_attention.py:127",
             launches=launches["attention_fwd"], max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
