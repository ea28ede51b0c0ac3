"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Parity runs in full f32 (TF32 off); bf16 is held to the f32 plain version at
atol/rtol 3e-2, the tolerance tests/test_pallas.py holds the TPU kernel's
bf16 output to.
"""

import pytest
import torch

from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("T,D", [(448, 32), (224, 48), (112, 64), (56, 64), (1024, 64), (13, 32)])
def test_k4_kernel_matches_plain(dev, T, D):
    """f32 at atol 2e-5 (out) / 1e-4 (LSE), strided q/k/v views."""
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((2, T, 3 * 8 * D), generator=gen, device=dev)
    q, k, v = (x.reshape(2, T, 8, D) for x in qkv.chunk(3, dim=-1))  # non-contiguous views
    before = k4.launches
    out, lse = k4.fused_attention_with_lse(q, k, v)
    assert k4.launches == before + 1
    ref, ref_lse = k4.fused_attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    outb = k4.fused_attention(qb, kb, vb)
    refb, _ = k4.fused_attention_plain(qb.float(), kb.float(), vb.float())
    torch.testing.assert_close(outb.float(), refb, atol=3e-2, rtol=3e-2)


def test_k4_rejects_unsupported_head_dim(dev):
    x = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        k4.fused_attention(x, x, x)


def _lm(dev, dtype):
    stack = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128)
    cfg = RoformerConfig(encoder=StackConfig(num_hidden_layers=2, **stack),
                         decoder=StackConfig(num_hidden_layers=1, **stack),
                         semantic_kmeans_num=300, n_spk=4)
    lm = RoformerSystem(cfg, dtype=dtype, device=dev, seed=0)
    gen = torch.Generator().manual_seed(0)
    phones = torch.randint(1, 60, (3, 11), generator=gen).to(dev)
    tones = torch.randint(0, 5, (3, 11), generator=gen).to(dev)
    with torch.no_grad():
        kvs = lm.module.compute_cross_kv(lm.module.encode(phones, tones, torch.ones_like(phones)))
    return lm, kvs, torch.tensor([11, 6, 9], dtype=torch.int32, device=dev)


def _sampling(cfg, N, **kw):
    return SamplingConfig(max_new_tokens=N, eos_token_id=cfg.semantic_eos,
                          pad_token_id=cfg.semantic_pad, bos_token_id=cfg.semantic_bos, **kw)


@pytest.mark.parametrize("gate", [None, 1e-9])
def test_k1_greedy_matches_plain_f32(dev, gate):
    """f32 greedy: tokens and lengths identical to the plain loop,
    including the cross_len mask and the end gate."""
    lm, kvs, clen = _lm(dev, torch.float32)
    sampling = _sampling(lm.cfg, 40, do_sample=False, end_gate_threshold=gate)
    before = k1.launches
    got = k1.roformer_decode(lm.module, sampling, kvs, clen)
    assert k1.launches == before + 1
    ref = k1.roformer_decode_plain(lm.module, sampling, kvs, clen)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r.cpu())


def test_k1_sampled_tokens_in_support_bf16(dev):
    """bf16 sampling: each token has a finite processed logit (the kernel's
    own raw logits through the plain processors); PAD after EOS."""
    lm, kvs, clen = _lm(dev, torch.bfloat16)
    N = 40
    sampling = _sampling(lm.cfg, N, do_sample=True, top_k=5, top_p=0.8)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks, lens, logits = k1.roformer_decode(lm.module, sampling, kvs, clen, generator=gen,
                                            debug_logits=True)
    B, V = toks.shape[0], lm.cfg.semantic_vocab_size
    rep = torch.zeros((B, V), dtype=torch.bool, device=dev)
    rep[:, lm.cfg.semantic_bos] = True
    for pos in range(N):
        live = pos < lens
        cur = toks[:, pos].long()
        chosen = process_logits(logits[:, pos], rep, sampling).gather(1, cur[:, None])[:, 0]
        assert bool(torch.isfinite(chosen[live]).all())
        assert bool((cur[~live] == lm.cfg.semantic_pad).all())
        rep[torch.arange(B, device=dev), cur] = True
