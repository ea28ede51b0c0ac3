"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Parity runs in full f32 (TF32 off); bf16 is held to the f32 plain version at
atol/rtol 3e-2, the tolerance tests/test_pallas.py holds the TPU kernel's
bf16 output to.  The fused UNet (K2/K3) is held to its plain version at
1e-3 of the output's scale in f32, and in bf16 to the K2/K3 contract
(tests/test_pallas_unet.py): corr > 0.999, max error <= max(4 x the plain
version's own bf16-vs-f32 error, 2% of scale).
"""

import pytest
import torch

import copy

from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded

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


# small UNet with head dims the kernel takes (32 and 48)
UNET = UNet1DConfig(in_channels=48, out_channels=16, block_out_channels=(64, 96), layers_per_block=1,
                    n_heads=2, norm_num_groups=8)


@pytest.mark.parametrize("T", [32, 72])
def test_unet_fwd_kernel_matches_plain(dev, T):
    m32 = seeded(lambda: UNet1D(UNET), 0).to(dev).eval()
    m16 = cast_compute_dtype(copy.deepcopy(m32), torch.bfloat16)
    m32r = cast_compute_dtype(copy.deepcopy(m16), torch.float32)  # the bf16 weights in f32
    p32, p16, p32r = (k23.pack_unet_params(m, UNET) for m in (m32, m16, m32r))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, T, UNET.in_channels), generator=gen, device=dev)
    t = torch.tensor([437.0], device=dev)
    with torch.no_grad():
        before = k23.launches
        got = k23.unet_fwd(p32, x, t, UNET)
        assert k23.launches == before + 1
        ref = k23.unet_fwd_plain(p32, x, t, UNET)
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, atol=1e-3 * scale, rtol=0)
        xb = x.bfloat16()
        gotb = k23.unet_fwd(p16, xb, t, UNET).float()
        plainb = k23.unet_fwd_plain(p16, xb, t, UNET).float()
        ref32 = k23.unet_fwd_plain(p32r, xb.float(), t, UNET)
    bound = max(4 * (plainb - ref32).abs().max().item(), 0.02 * ref32.abs().max().item())
    assert (gotb - ref32).abs().max().item() <= bound
    assert torch.corrcoef(torch.stack([gotb.flatten(), ref32.flatten()]))[0, 1].item() > 0.999


def test_unit2mel_pallas_routes_b1_through_the_kernel(dev):
    cfg = Unit2MelConfig(input_channel=16, n_spk=4, out_dims=16, n_hidden=32, block_out_channels=(64, 96),
                         n_layers=1, n_heads=2, timesteps=50, k_step=50)
    sys_ = Unit2MelSystem(cfg, dtype=torch.bfloat16, device=dev, seed=0, unet_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(0)
    spk = torch.ones((1, 1), dtype=torch.long, device=dev)
    before = k23.launches
    out = sys_.infer(torch.randn((1, 16, 16), generator=gen, device=dev), spk_id=spk, infer_speedup=10)
    assert k23.launches == before + 5  # one launch per denoiser evaluation
    assert torch.isfinite(out.float()).all()
    before = k23.launches
    out = sys_.infer(torch.randn((2, 16, 16), generator=gen, device=dev), spk_id=spk.expand(2, 1),
                     infer_speedup=10)
    assert k23.launches == before  # B > 1: the eager module
    assert out.shape == (2, 16, 16)
