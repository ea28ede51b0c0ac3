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
version's own bf16-vs-f32 error, 2% of scale).  The K4 backward is held to
its plain version at atol 3e-5 / rtol 1e-4 in f32 (the JAX contract), and
in bf16 to the f32 plain backward of the same bf16 inputs within 2^-5 of
each gradient's scale (see `test_k4_bwd_kernel_matches_plain`).  K6 must
give exactly the plain version's ids.  Gradients through a small UNet on
the card are held to the CPU plain path's at rtol 1e-3 / atol 1e-4 of each
gradient's scale (f32 sums in another order through the whole network).
K5 is held to its plain version at atol 2e-5 in f32 (the JAX contract) and
in bf16 within 1e-2 of max|out| of the plain version on the same bf16
inputs (the same f32 arithmetic, rounded once).

The bf16 entries of K4 forward and K5 run on the tensor cores; besides the
tolerances above, at most 2% of their bf16 outputs may differ from the
plain version's bf16 outputs on the same inputs (rounding p to bf16 where
K5 keeps it f32, or rounding it before normalising where K4 rounds after,
changes 40-50%), and K4's LSE stays within 1e-4 of the plain version's.
"""

import copy
import functools
from unittest import mock

import pytest
import torch

from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
from latent_diffusion_speech_tpu_torch.ops import attention
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer, step_generator

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("T,D", [(448, 32), (224, 48), (112, 64), (56, 64), (1024, 64), (13, 32), (224, 8), (56, 8)])
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


@pytest.mark.parametrize("B,Tq,Tkv,D,causal", [
    (1, 448, 448, 32, False), (4, 224, 224, 48, False), (1, 112, 112, 64, False), (1, 100, 260, 64, False),
    (1, 96, 96, 32, True), (2, 70, 200, 64, True), (2, 200, 70, 48, True), (1, 13, 5, 32, False),
    (1, 224, 224, 8, False), (2, 70, 130, 8, True), (1, 13, 5, 8, False)])
def test_k5_kernel_matches_plain(dev, B, Tq, Tkv, D, causal):
    """Strided q/k/v views (a fused projection's slices, a transposed v)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, Tq, 3 * 8 * D), generator=gen, device=dev)[..., : 8 * D].reshape(B, Tq, 8, D)
    k = torch.randn((B, Tkv, 8, D), generator=gen, device=dev)
    v = torch.randn((B, 8, Tkv, D), generator=gen, device=dev).transpose(1, 2)
    with torch.no_grad():
        before = k5.launches
        out = k5.flash_attention(q, k, v, is_causal=causal)
        assert k5.launches == before + 1
        torch.testing.assert_close(out, k5.flash_attention_plain(q, k, v, causal), atol=2e-5, rtol=0)
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        outb = k5.flash_attention(qb, kb, vb, is_causal=causal)
        refb = k5.flash_attention_plain(qb, kb, vb, causal).float()
    assert outb.dtype == torch.bfloat16
    assert (outb.float() - refb).abs().max().item() <= 1e-2 * refb.abs().max().item()


def test_k5_rejects_unsupported_head_dim_and_gradients(dev):
    x = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="head dim 16"):
        k5.flash_attention(x, x, x)
    y = torch.zeros((1, 8, 2, 32), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        k5.flash_attention(y, y, y)


@pytest.mark.parametrize("B,T,H", [(1, 224, 48), (4, 56, 64), (1, 448, 32)])
def test_head_dim_8_kernels_at_zoo_shapes(dev, B, T, H):
    """K5 and the K4 forward at the block zoo's head dim 8 and head counts:
    f32 against the plain versions (atol 2e-5, K4's LSE 1e-4); bf16 within
    1e-2 (K5) / 3e-2 (K4) of max|out| of the plain version on the same
    inputs, at most 2% of the bf16 outputs differing from it."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (x.reshape(B, T, H, 8) for x in torch.randn((B, T, 3 * H * 8), generator=gen, device=dev).chunk(3, -1))
    with torch.no_grad():
        torch.testing.assert_close(k5.flash_attention(q, k, v), k5.flash_attention_plain(q, k, v), atol=2e-5, rtol=0)
        out, lse = k4.fused_attention_with_lse(q, k, v)
        ref, ref_lse = k4.fused_attention_plain(q, k, v)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        for got, plain, tol in ((k5.flash_attention(qb, kb, vb), k5.flash_attention_plain(qb, kb, vb), 1e-2),
                                (k4.fused_attention(qb, kb, vb), k4.fused_attention_plain(qb, kb, vb)[0], 3e-2)):
            assert got.dtype == torch.bfloat16
            assert (got.float() - plain.float()).abs().max().item() <= tol * plain.float().abs().max().item()
            assert (got != plain).float().mean().item() <= 0.02


def test_k4_backward_at_head_dim_8(dev):
    """A call that needs a gradient at head dim 8 runs the K4 forward and
    backward kernels, and its gradients are the plain backward's (f32, atol
    3e-5 / rtol 1e-4)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 40, 4, 8), generator=gen, device=dev, requires_grad=True) for _ in range(3))
    dout = torch.randn((2, 40, 4, 8), generator=gen, device=dev)
    fwd, bwd = k4.launches, k4.bwd_launches
    k4.fused_attention(q, k, v).backward(dout)
    assert (k4.launches - fwd, k4.bwd_launches - bwd) == (1, 1)
    with torch.no_grad():
        out, lse = k4.fused_attention_plain(q, k, v)
        ref = k4.fused_attention_bwd_plain(q, k, v, out, dout, lse)
    for x, r, name in zip((q, k, v), ref, ("dq", "dk", "dv")):
        torch.testing.assert_close(x.grad, r, atol=3e-5, rtol=1e-4, msg=name)


ZOO_ON_CARD = {  # two of the block zoo's configurations: every attention block type between them
    "zoo_attn": (("ResnetDownsampleBlock2D", "AttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "DownBlock2D"),
                 ("UpBlock2D", "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "ResnetUpsampleBlock2D"),
                 "UNetMidBlock2DSimpleCrossAttn"),
    "zoo_k": (("KDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D"),
              ("KCrossAttnUpBlock2D",) * 3 + ("KUpBlock2D",), None),
}


@pytest.mark.parametrize("name", sorted(ZOO_ON_CARD))
def test_zoo_denoiser_forward_runs_k5_on_the_card(dev, name):
    """A small zoo configuration (its attention at head dim 8): one forward
    is one K5 launch per attention module, no call routed to the plain
    attention, and matches the same forward with K5's plain version (f32,
    1e-3 of the output's scale); with attn_impl="fused" the same forward is
    that many K4 launches and matches too."""
    from latent_diffusion_speech_tpu_torch.models.diffusion import blocks as bl

    down, up, mid = ZOO_ON_CARD[name]
    zoo = dict(denoiser="general", block_out_channels=(64, 64, 128, 128), n_layers=1, down_block_types=down,
               up_block_types=up, mid_block_type=mid)
    sys_ = Unit2MelSystem(Unit2MelConfig(attn_impl="pallas", **zoo), device=dev, seed=0)
    n_attn = sum(isinstance(m, (bl.CrossAttention1D, bl.AttnBlock1D, bl.AddedKVAttention1D))
                 for m in sys_.module.modules())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 64, 384), generator=gen, device=dev)
    t = torch.tensor([437], device=dev)
    with torch.no_grad():
        before = (k5.launches, k5.plain_routes, k4.launches)
        got = sys_.module.denoise(x, t)
        assert (k5.launches - before[0], k5.plain_routes - before[1], k4.launches - before[2]) == (n_attn, 0, 0)
        real = attention.flash_attention
        attention.flash_attention = lambda q, k, v, **kw: k5.flash_attention_plain(q, k, v)
        try:
            ref = sys_.module.denoise(x, t)
        finally:
            attention.flash_attention = real
        torch.testing.assert_close(got, ref, atol=1e-3 * ref.abs().max().item(), rtol=0)
        fused = Unit2MelSystem(Unit2MelConfig(attn_impl="fused", **zoo), device=dev, seed=0)
        before = k4.launches
        torch.testing.assert_close(fused.module.denoise(x, t), ref, atol=1e-3 * ref.abs().max().item(), rtol=0)
        assert k4.launches - before == n_attn


def test_general_denoiser_forward_runs_k5_on_the_card(dev):
    """The full-width general denoiser: one forward is 32 K5 launches (no
    K4, no call routed to the plain attention) and matches the same forward
    with K5's plain version (f32, 1e-3 of the output's scale)."""
    sys_ = Unit2MelSystem(Unit2MelConfig(denoiser="general", attn_impl="pallas"), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 64, 384), generator=gen, device=dev)
    t = torch.tensor([437], device=dev)
    with torch.no_grad():
        before = (k5.launches, k5.plain_routes, k4.launches)
        got = sys_.module.denoise(x, t)
        assert (k5.launches - before[0], k5.plain_routes - before[1], k4.launches - before[2]) == (32, 0, 0)
        real = attention.flash_attention
        attention.flash_attention = lambda q, k, v, **kw: k5.flash_attention_plain(q, k, v)
        try:
            ref = sys_.module.denoise(x, t)
        finally:
            attention.flash_attention = real
    torch.testing.assert_close(got, ref, atol=1e-3 * ref.abs().max().item(), rtol=0)


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
    """f32 greedy: tokens identical to the plain loop up to the first step a
    rounding flips an argmax, logits close up to and including it (see
    `_k1_equals_plain`), including the cross_len mask and the end gate."""
    lm, kvs, clen = _lm(dev, torch.float32)
    sampling = _sampling(lm.cfg, 40, do_sample=False, end_gate_threshold=gate)
    before = k1.launches
    k1.roformer_decode(lm.module, sampling, kvs, clen)
    assert k1.launches == before + 1
    _logits_match_plain(lm, kvs, clen, sampling, K1_F32_REL, K1_F32_CORR)


def _lm_wide(dev, dtype, C=256, H=8, B=4, L=24):
    """A decoder of the given width (I = 512, the flagship's) over a 1-layer
    encoder; cross_len ragged."""
    cfg = RoformerConfig(encoder=StackConfig(num_hidden_layers=1, hidden_size=C, num_attention_heads=H),
                         decoder=StackConfig(num_hidden_layers=1, hidden_size=C, num_attention_heads=H))
    lm = RoformerSystem(cfg, dtype=dtype, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    phones = torch.randint(1, 60, (B, L), generator=gen).to(dev)
    tones = torch.randint(0, 5, (B, L), generator=gen).to(dev)
    clen = torch.randint(L // 2, L + 1, (B,), generator=gen).to(device=dev, dtype=torch.int32)
    mask = (torch.arange(L, device=dev)[None] < clen[:, None]).long()
    with torch.no_grad():
        kvs = lm.module.compute_cross_kv(lm.module.encode(phones, tones, torch.ones_like(phones), mask))
    return lm, kvs, clen


# f32 K1 against its plain decode: the raw logits within this share of their
# scale (f32 sums of C=256 and 512 terms in other orders), and correlated
K1_F32_REL, K1_F32_CORR = 1e-4, 0.999999


def _k1_equals_plain(lm, kvs, clen, N):
    """f32 greedy: the seeded weights draw flax's initialisers, so the
    logits are of unit scale and a top-2 gap can fall within f32 summation
    order: tokens identical up to the first step whose argmax flips, raw
    logits within K1_F32_REL of their scale up to and including it."""
    sampling = _sampling(lm.cfg, N, do_sample=False)
    before = k1.launches
    k1.roformer_decode(lm.module, sampling, kvs, clen)
    assert k1.launches == before + 1
    _logits_match_plain(lm, kvs, clen, sampling, K1_F32_REL, K1_F32_CORR)


@pytest.mark.parametrize("B", [1, 4, 20])
def test_k1_cluster_greedy_matches_plain_f32_flagship_width(dev, B):
    """f32 greedy at C=256, H=8 (clusters of 8): identical tokens and
    lengths.  At B=20 the 20 clusters (124 KB of shared memory a block, one
    block an SM) outnumber those the card holds at once."""
    lm, kvs, clen = _lm_wide(dev, torch.float32, B=B)
    p, n = k1.max_active_clusters(lm.module, _sampling(lm.cfg, 430, do_sample=False), kvs, clen)
    assert p.CL == 8 and p.kv_smem and not p.ckv_smem and n >= 1  # the encoder K/V in device memory
    if B == 20:
        assert n < B
    _k1_equals_plain(lm, kvs, clen, N=430)


@pytest.mark.parametrize("C,H", [(128, 4), (192, 6)])
def test_k1_cluster_greedy_matches_plain_f32_other_heads(dev, C, H):
    """H=4 (clusters of 4) and H=6 (clusters of 2, three heads a block)."""
    _k1_equals_plain(*_lm_wide(dev, torch.float32, C=C, H=H), N=200)


def test_lm_train_step_gradients_are_bitwise_repeatable(dev):
    """The LM trainer's backward on the card: with more than 3072 token
    positions, most of them a few repeated phones, two backward passes of
    the same step give bitwise-equal gradients (CUDA's embedding backward
    accumulates with atomics there outside PyTorch's deterministic mode,
    which `LMTrainer.train_step` turns on around the backward)."""
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer, deterministic_algorithms

    stack = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128, num_hidden_layers=1)
    cfg = RoformerConfig(encoder=StackConfig(**stack), decoder=StackConfig(**stack), semantic_kmeans_num=300, n_spk=4)
    trainer = LMTrainer(Config(), lm_cfg=cfg, device=dev)
    gen = torch.Generator().manual_seed(3)
    B, L, S = 16, 256, 320
    batch = {"phone": torch.randint(1, 6, (B, L), generator=gen), "tone": torch.randint(0, 3, (B, L), generator=gen),
             "semantic": torch.randint(0, 300, (B, S), generator=gen), "spk_id": torch.ones((B, L), dtype=torch.long),
             "encoder_attention_mask": torch.ones((B, L), dtype=torch.long),
             "attention_mask": torch.ones((B, S), dtype=torch.long)}
    batch["labels"] = batch["semantic"].clone()
    batch = {k: v.to(dev) for k, v in batch.items()}
    grads = []
    for _ in range(3):
        trainer.optimizer.zero_grad(set_to_none=True)
        loss = trainer.system.loss(batch, step_generator(0, 0, dev))
        with deterministic_algorithms():
            loss.backward()
        grads.append({n: p.grad.clone() for n, p in trainer.system.module.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]) and torch.equal(grads[0][name], grads[2][name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_follows_weights_copied_in_with_load_state_dict(dev, dtype):
    """K1's packed-weight cache under a weight swap, as the LM trainer's
    `validate_audio` makes one: new f32 weights copied into a served LM with
    `load_state_dict` (cast to its dtype) move the parameters' version
    counters, so the next decode packs them again: K1's greedy tokens differ
    from the old weights' and equal the plain decode's at the new weights up
    to the first step a rounding flips an argmax, the logits within 2% of
    their scale up to it in bf16 and within K1_F32_REL in f32, as
    chip_smoke.py's check_k1 holds them."""
    lm, _, clen = _lm_wide(dev, dtype)
    sampling = _sampling(lm.cfg, 200, do_sample=False)
    gen = torch.Generator().manual_seed(2)
    B, L = clen.shape[0], int(clen.max())
    phones = torch.randint(1, 60, (B, L), generator=gen).to(dev)
    tones = torch.randint(0, 5, (B, L), generator=gen).to(dev)
    mask = (torch.arange(L, device=dev)[None] < clen[:, None]).long()

    def decode(fn, **kw):
        with torch.no_grad():
            kvs = lm.module.compute_cross_kv(lm.module.encode(phones, tones, torch.ones_like(phones), mask))
        return fn(lm.module, sampling, kvs, clen, **kw)

    old = decode(k1.roformer_decode)
    trained = RoformerSystem(lm.cfg, device=dev, seed=1)  # f32, as the trainer holds it
    lm.module.load_state_dict(trained.module.state_dict())
    before = k1.launches
    got = decode(k1.roformer_decode)
    assert k1.launches == before + 1
    ref = decode(k1.roformer_decode_plain)
    assert not torch.equal(got[0], old[0])
    toks, lens, lg = decode(k1.roformer_decode, debug_logits=True)
    _, _, lg_ref = decode(k1.roformer_decode_plain, debug_logits=True)
    differ = (toks != ref[0]).any(dim=0).nonzero()
    n_cmp = int(differ[0]) + 1 if len(differ) else sampling.max_new_tokens
    live = torch.arange(n_cmp, device=dev)[None, :] < lens[:, None]
    a, b = lg[:, :n_cmp][live], lg_ref[:, :n_cmp][live]
    rel = K1_F32_REL if dtype == torch.float32 else 0.02
    assert (a - b).abs().max().item() <= rel * b.abs().max().item()


def test_k1_cluster_greedy_matches_plain_f32_n1024(dev):
    """N=1024, the serve default max_length: the f32 KV cache no longer
    fits in shared memory and lives in device memory (the encoder K/V of
    L=24 rows then fits there)."""
    lm, kvs, clen = _lm_wide(dev, torch.float32, B=2)
    C, H = lm.cfg.decoder.hidden_size, lm.cfg.decoder.num_attention_heads
    p = k1.plan(C, H, 512, lm.cfg.semantic_vocab_size, kvs[0][0].shape[1], 1024, 1, 4)
    assert not p.kv_smem and p.ckv_smem
    _k1_equals_plain(lm, kvs, clen, N=1024)


@pytest.mark.parametrize("encoder_kv_smem", [True, False])
def test_k1_encoder_kv_placement_greedy_matches_plain_f32(dev, encoder_kv_smem):
    """f32 greedy at N=200, L=48, where the plan keeps the encoder K/V in
    shared memory, and the same decode with it forced into device memory:
    both identical to the plain loop."""
    lm, kvs, clen = _lm_wide(dev, torch.float32, L=48)
    C, H = lm.cfg.decoder.hidden_size, lm.cfg.decoder.num_attention_heads
    assert k1.plan(C, H, 512, lm.cfg.semantic_vocab_size, 48, 200, 1, 4).ckv_smem
    with mock.patch.object(k1, "plan", functools.partial(k1.plan, encoder_kv_smem=encoder_kv_smem)):
        _k1_equals_plain(lm, kvs, clen, N=200)


def test_k1_bf16_logits_match_plain_at_the_serve_default_n1024(dev):
    """bf16 greedy at flagship width and N=1024 (`TTSPipeline.tts`'s
    max_length), the serve default's plan: the KV cache in shared memory
    behind a two-slot weight ring, the encoder K/V in device memory.  The
    raw logits of each stream's steps up to its EOS (the kernel writes no
    logits after it) agree within 2% of their scale, corr >= 0.9999, up to
    and including the first step whose token differs."""
    lm, kvs, clen = _lm_wide(dev, torch.bfloat16, L=48)
    sampling = _sampling(lm.cfg, 1024, do_sample=False)
    p, _ = k1.max_active_clusters(lm.module, sampling, kvs, clen)
    assert p.kv_smem and not p.ckv_smem and p.stages == 2
    _bf16_logits_match_plain(lm, kvs, clen, sampling)


def _logits_match_plain(lm, kvs, clen, sampling, rel, min_corr):
    """The raw logits of each stream's steps up to its EOS (the kernel
    writes no logits after it) within `rel` of their scale, correlation >=
    `min_corr`, up to and including the first step whose token differs."""
    dev = clen.device
    toks, lens, lg = k1.roformer_decode(lm.module, sampling, kvs, clen, debug_logits=True)
    toks_p, _, lg_p = k1.roformer_decode_plain(lm.module, sampling, kvs, clen, debug_logits=True)
    differ = (toks != toks_p).any(dim=0).nonzero()
    n = int(differ[0]) + 1 if len(differ) else sampling.max_new_tokens
    live = torch.arange(n, device=dev)[None, :] < lens[:, None]
    a, b = lg[:, :n][live].flatten(), lg_p[:, :n][live].flatten()
    assert (a - b).abs().max().item() <= rel * b.abs().max().item()
    assert torch.corrcoef(torch.stack([a, b]))[0, 1].item() >= min_corr


def _bf16_logits_match_plain(lm, kvs, clen, sampling):
    _logits_match_plain(lm, kvs, clen, sampling, 0.02, 0.9999)


@pytest.mark.parametrize("B", [2, 8])
def test_k1_bf16_at_the_http_servers_batch_sizes(dev, B):
    """The HTTP server's batches (2 requests pad to B=2, 5-8 to B=8) at
    flagship width, N=1024 (the serve default max_length) over 64 encoder
    rows (the phone bucket of a 60-character EN piece): logits as in the
    test above, and sampled tokens in the processed support."""
    lm, kvs, clen = _lm_wide(dev, torch.bfloat16, B=B, L=64)
    _bf16_logits_match_plain(lm, kvs, clen, _sampling(lm.cfg, 1024, do_sample=False))
    p, n = k1.max_active_clusters(lm.module, _sampling(lm.cfg, 1024, do_sample=False), kvs, clen)
    assert p.CL == 8 and n >= 1
    _sampled_in_support(lm, kvs, clen, 1024)


def test_k1_sampled_tokens_in_support_bf16(dev):
    """bf16 sampling: each token has a finite processed logit (the kernel's
    own raw logits through the plain processors); PAD after EOS."""
    lm, kvs, clen = _lm(dev, torch.bfloat16)
    _sampled_in_support(lm, kvs, clen, 40)


def _sampled_in_support(lm, kvs, clen, N):
    dev = clen.device
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


@pytest.mark.parametrize("T", [64, 448, 1024])
def test_unet_fwd_flagship_matches_plain(dev, T):
    """The flagship width (256, 384, 512, 512) at the serve path's frame
    buckets, under the same two checks as the small UNet above."""
    cfg = UNet1DConfig()
    m32 = seeded(lambda: UNet1D(cfg), 0).to(dev).eval()
    m16 = cast_compute_dtype(copy.deepcopy(m32), torch.bfloat16)
    m32r = cast_compute_dtype(copy.deepcopy(m16), torch.float32)
    p32, p16, p32r = (k23.pack_unet_params(m, cfg) for m in (m32, m16, m32r))
    x = torch.randn((1, T, cfg.in_channels), generator=torch.Generator(device=dev).manual_seed(T), device=dev)
    t = torch.tensor([437.0], device=dev)
    with torch.no_grad():
        ref = k23.unet_fwd_plain(p32, x, t, cfg)
        torch.testing.assert_close(k23.unet_fwd(p32, x, t, cfg), ref, atol=1e-3 * ref.abs().max().item(), rtol=0)
        xb = x.bfloat16()
        gotb = k23.unet_fwd(p16, xb, t, cfg).float()
        plainb = k23.unet_fwd_plain(p16, xb, t, cfg).float()
        ref32 = k23.unet_fwd_plain(p32r, xb.float(), t, cfg)
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


# the diffusion trainer's K4 shapes (T, D) at H=8, and ragged multi-tile T
K4_BWD_SHAPES = [(88, 32), (44, 48), (22, 64), (11, 64), (13, 32), (130, 48)]


def _check_k4_bwd(dev, B, T, H, D):
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=dev)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.chunk(3, dim=-1))
    dout = torch.randn((B, H, T, D), generator=gen, device=dev).transpose(1, 2)  # strided rows
    out, lse = k4.fused_attention_with_lse(q, k, v)
    before = k4.bwd_launches
    got = k4.attention_bwd(q, k, v, out, dout, lse)
    assert k4.bwd_launches == before + 1
    ref = k4.fused_attention_bwd_plain(q, k, v, out, dout, lse)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, r, atol=3e-5, rtol=1e-4, msg=name)
    qb, kb, vb, db = (x.bfloat16() for x in (q, k, v, dout))
    outb, lseb = k4.fused_attention_with_lse(qb, kb, vb)
    out32, lse32 = k4.fused_attention_plain(qb.float(), kb.float(), vb.float())
    ref32 = k4.fused_attention_bwd_plain(qb.float(), kb.float(), vb.float(), out32, db.float(), lse32)
    for g, r, name in zip(k4.attention_bwd(qb, kb, vb, outb, db, lseb), ref32, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 2**-5 * r.abs().max().item(), name


@pytest.mark.parametrize("T,D", K4_BWD_SHAPES)
def test_k4_bwd_kernel_matches_plain(dev, T, D):
    """f32 at atol 3e-5 / rtol 1e-4 with strided q/k/v views and a
    non-contiguous dout; bf16 against the f32 plain backward of the same
    bf16 inputs within 2^-5 of each gradient's scale: p, ds, out and the
    outputs are each rounded to bf16 once (2^-9 relative), and the sums
    over T add those roundings with random signs, so the error stays a few
    roundings of the scale; 2^-5 leaves a wide margin."""
    _check_k4_bwd(dev, 4, T, 8, D)


# the block zoo's training shapes at head dim 8 (B = 48, a 1 s crop: T at
# each level, H = channels / 8), and a ragged multi-tile T
K4_BWD_ZOO_SHAPES = [(88, 32), (44, 48), (22, 64), (11, 64), (130, 4)]


@pytest.mark.parametrize("T,H", K4_BWD_ZOO_SHAPES)
def test_k4_bwd_kernel_matches_plain_at_head_dim_8(dev, T, H):
    """Head dim 8 at the zoo's training shapes, held as
    `test_k4_bwd_kernel_matches_plain` holds the other head dims."""
    _check_k4_bwd(dev, 48, T, H, 8)


@pytest.mark.parametrize("T,D", [(11, 64), (16, 32), (11, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_bwd_16_key_tiles_equal_32_key_tiles(dev, T, D, dtype):
    """Where T <= 16 the plan takes 16-key tiles, four heads a block; 32-key
    tiles, a head a block, give the same gradients bit for bit (the same
    sums in the same order, the extra rows zero)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v, dout = (torch.randn((6, T, 8, D), generator=gen, device=dev).to(dtype) for _ in range(4))
    out, lse = k4.fused_attention_with_lse(q, k, v)
    assert k4.bwd_plan(6, T, 8, D)["tile"] == 16
    narrow = k4.attention_bwd(q, k, v, out, dout, lse)
    with mock.patch.object(k4, "bwd_plan", functools.partial(k4.bwd_plan, tile=32)):
        wide = k4.attention_bwd(q, k, v, out, dout, lse)
    for x, y in zip(narrow, wide):
        assert torch.equal(x, y)


@pytest.mark.parametrize("T,D", K4_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_bwd_two_calls_are_bit_identical(dev, T, D, dtype):
    """dq from several key tiles is summed in key-tile order, no atomics:
    the trainer's bitwise resume needs the same gradients on every call."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, dout = (torch.randn((6, T, 8, D), generator=gen, device=dev).to(dtype) for _ in range(4))
    out, lse = k4.fused_attention_with_lse(q, k, v)
    first = k4.attention_bwd(q, k, v, out, dout, lse)
    for _ in range(3):
        for g, f in zip(k4.attention_bwd(q, k, v, out, dout, lse), first):
            assert torch.equal(g, f)


# contract shapes, ragged N < 128 and K < 128, D = 33 and 1281 (masked
# scalar loads), the trainer's size, and stage 19's ragged N (one file's
# unit frames) against the 4096 x 1280 codebook
K6_SHAPES = [(300, 700, 32), (256, 512, 64), (1000, 777, 50), (100, 90, 33), (5, 3, 16), (257, 300, 1281),
             (4128, 4096, 1280), (151, 4096, 1280), (377, 4096, 1280), (1003, 4096, 1280),
             (8192, 4096, 1280)]  # stage 17's minibatch


@pytest.mark.parametrize("n,k,d", K6_SHAPES)
def test_k6_kernel_matches_plain(dev, n, k, d):
    """Ids equal to the plain version's; against the 4096-code codebook
    with units near their centroids (as k-means units are), and at the
    contract shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cb = torch.randn((k, d), generator=gen, device=dev)
    if k == 4096:
        x = cb[torch.randint(0, k, (n,), generator=gen, device=dev)] + 0.3 * torch.randn(
            (n, d), generator=gen, device=dev)
    else:
        x = torch.randn((n, d), generator=gen, device=dev)
    before = k6.launches
    got = k6.kmeans_argmin(x, cb)
    assert k6.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got, k6.kmeans_argmin_plain(x, cb))


def test_k6_exact_ties_go_to_the_lowest_index(dev):
    """Duplicated codebook rows give exactly equal distances: the lowest
    index wins, inside a code tile, across tiles and across code splits."""
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((200, 64), generator=gen, device=dev)
    cb = torch.cat([base, base, base[:50]])  # code i, i + 200 and (i < 50) i + 400 are equal
    x = base[torch.randint(0, 200, (500,), generator=gen, device=dev)].clone()
    got = k6.kmeans_argmin(x, cb)
    assert bool((got < 200).all())
    assert torch.equal(got, k6.kmeans_argmin_plain(x, cb))


@pytest.mark.parametrize("aligned", [True, False])
def test_k6_one_split_equals_many(dev, aligned):
    """The code-range split and its ordered merge give the ids of one block
    walking every code; a view 4 bytes off the 16-byte grid takes the
    masked scalar loads and gives the same ids."""
    gen = torch.Generator(device=dev).manual_seed(2)
    n, k, d = 700, 1500, 128
    flat = torch.randn((n * d + 1,), generator=gen, device=dev)
    x = flat[:n * d].view(n, d) if aligned else flat[1:].view(n, d)
    cb = torch.randn((k, d), generator=gen, device=dev)
    many = k6.kmeans_argmin(x, cb)
    chosen = k6.split_codes
    try:
        assert chosen(n, k, torch.cuda.get_device_properties(dev).multi_processor_count)[0] > 1
        k6.split_codes = lambda n, k, sms: (1, -(-k // k6.BLOCK_CODES) * k6.BLOCK_CODES)
        one = k6.kmeans_argmin(x, cb)
    finally:
        k6.split_codes = chosen
    assert torch.equal(one, many)
    assert torch.equal(many, k6.kmeans_argmin_plain(x, cb))


def test_unet_gradients_flow_through_k4_on_the_card(dev):
    """loss.backward() through a small UNet1D on the card reaches every
    to_q / to_k / to_v weight through K4's backward, and every gradient
    matches the CPU plain path's."""
    m_cpu = seeded(lambda: UNet1D(UNET), 0)
    m_dev = copy.deepcopy(m_cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 24, UNET.in_channels), generator=gen)
    t = torch.tensor([3.0, 400.0, 999.0])
    target = torch.randn((3, 24, UNET.out_channels), generator=gen)
    fwd, bwd = k4.launches, k4.bwd_launches
    ((m_dev(x.to(dev), t.to(dev)) - target.to(dev)) ** 2).mean().backward()
    n_attn = sum(1 for name, _ in m_dev.named_modules() if name.endswith(("attn1", "attn2")))
    assert (k4.launches - fwd, k4.bwd_launches - bwd) == (n_attn, n_attn)
    ((m_cpu(x, t) - target) ** 2).mean().backward()
    cpu = dict(m_cpu.named_parameters())
    for name, p in m_dev.named_parameters():
        if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight")):
            assert p.grad is not None and p.grad.abs().max().item() > 0, name
        ref = cpu[name].grad
        torch.testing.assert_close(p.grad.cpu(), ref, rtol=1e-3, atol=1e-4 * ref.abs().max().item(), msg=name)


def test_trainer_trains_in_f32_on_the_card(dev):
    """Making the trainer on the card turns TF32 off for matmuls and cuDNN
    convolutions, whatever the process had set, and a step runs through
    K4 forward and backward."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    cfg = Config()
    cfg.data.encoder = "hubert_soft"
    model = Unit2MelConfig(input_channel=256, n_spk=1, out_dims=16, n_hidden=32, block_out_channels=(64, 96),
                           n_layers=1, n_heads=2, timesteps=50, k_step=50)
    trainer = DiffusionTrainer(cfg, model_cfg=model, device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"units": torch.randn((2, 24, 256), generator=gen, device=dev),
             "mel": torch.randn((2, 24, 16), generator=gen, device=dev)}
    fwd, bwd = k4.launches, k4.bwd_launches
    loss = trainer.train_step(batch, step_generator(0, 0, dev))["loss"]
    assert bool(torch.isfinite(loss)) and k4.launches > fwd and k4.bwd_launches - bwd == k4.launches - fwd


def _views(dev, B, Tq, Tkv, D, dtype=torch.bfloat16, seed=0):
    """q a slice of a fused projection, k a contiguous tensor, v a transposed
    (B, H, Tkv, D) tensor: the layouts the callers hand over."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Tq, 3 * 8 * D), generator=gen, device=dev)[..., 8 * D: 16 * D].reshape(B, Tq, 8, D)
    k = torch.randn((B, Tkv, 8, D), generator=gen, device=dev)
    v = torch.randn((B, 8, Tkv, D), generator=gen, device=dev).transpose(1, 2)
    return tuple(x.to(dtype) for x in (q, k, v))


def _differing(got, ref):
    return (got != ref).float().mean().item()


# K4 forward in bf16: the serve path's (B, T, D) at H=8 (tts at B=1, tts_batch
# at B=4, the 1024-frame bucket), the four resolutions of that bucket at the
# HTTP server's batch sizes (1, 2, and 5-8 requests padded to 8), and ragged T
K4_BF16 = [(1, 448, 32), (1, 224, 48), (1, 112, 64), (1, 56, 64), (1, 1024, 64), (4, 448, 32), (4, 56, 64),
           (1, 13, 32), (2, 70, 48), (2, 100, 64), (1, 200, 32)]
K4_BF16 += [(b, t, d) for b in (1, 2, 8) for t, d in ((1024, 32), (512, 48), (256, 64), (128, 64))]
# the SVC path's (chip_smoke.py's svc input): the four UNet resolutions of
# its segments' 576-, 960- and 1344-frame buckets at B=1
K4_BF16 += [(1, t // s, d) for t in (576, 960, 1344) for s, d in ((1, 32), (2, 48), (4, 64), (8, 64))]


@pytest.mark.parametrize("B,T,D", K4_BF16)
def test_k4_bf16_tensor_cores_match_plain(dev, B, T, D):
    q, k, v = _views(dev, B, T, T, D)
    before = k4.launches
    out, lse = k4.fused_attention_with_lse(q, k, v)
    assert k4.launches == before + 1 and out.dtype == torch.bfloat16
    ref32, _ = k4.fused_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref32, atol=3e-2, rtol=3e-2)
    ref, ref_lse = k4.fused_attention_plain(q, k, v)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert _differing(out, ref) <= 0.02


K5_BF16 = [(b, t, t, d, False) for b in (1, 4) for t, d in ((448, 32), (224, 48), (112, 64), (56, 64), (1024, 32))]
K5_BF16 += [(1, 100, 260, 64, False), (1, 96, 96, 32, True), (2, 70, 200, 64, True), (2, 200, 70, 48, True),
            (1, 13, 13, 32, False), (1, 70, 70, 48, True), (2, 100, 100, 64, False), (1, 200, 200, 32, True),
            (1, 13, 5, 32, False)]


@pytest.mark.parametrize("B,Tq,Tkv,D,causal", K5_BF16)
def test_k5_bf16_tensor_cores_match_plain(dev, B, Tq, Tkv, D, causal):
    q, k, v = _views(dev, B, Tq, Tkv, D)
    with torch.no_grad():
        before = k5.launches
        out = k5.flash_attention(q, k, v, is_causal=causal)
        assert k5.launches == before + 1 and out.dtype == torch.bfloat16
        ref = k5.flash_attention_plain(q, k, v, causal)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    assert _differing(out, ref) <= 0.02


@pytest.mark.parametrize("T,D", [(88, 32), (44, 48), (13, 64)])
def test_fused_attention_bf16_forward_and_backward(dev, T, D):
    """FusedAttention in bf16 (the tensor-core forward, its LSE into the
    backward kernel) against the f32 plain forward and backward of the same
    bf16 inputs, within 2^-5 of each output's scale."""
    q, k, v = (x.detach().requires_grad_() for x in _views(dev, 4, T, T, D))
    dout = torch.randn((4, T, 8, D), generator=torch.Generator(device=dev).manual_seed(1), device=dev).bfloat16()
    fwd, bwd = k4.launches, k4.bwd_launches
    out = k4.fused_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (k4.launches - fwd, k4.bwd_launches - bwd) == (1, 1)
    qf, kf, vf = (x.detach().float() for x in (q, k, v))
    out32, lse32 = k4.fused_attention_plain(qf, kf, vf)
    ref = k4.fused_attention_bwd_plain(qf, kf, vf, out32, dout.float(), lse32)
    for g, r, name in zip((out, *grads), (out32, *ref), ("out", "dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 2**-5 * r.abs().max().item(), name


def test_bf16_wrappers_replay_in_a_cuda_graph(dev):
    """Each wrapper captured in a CUDA graph and replayed gives its eager
    output bit for bit (no sync and no host read of device data inside)."""
    q, k, v = _views(dev, 1, 448, 448, 32)
    with torch.no_grad():
        eager = (k5.flash_attention(q, k, v), k5.flash_attention(q, k, v, is_causal=True),
                 *k4.fused_attention_with_lse(q, k, v))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
            k5.flash_attention(q, k, v)
            k4.fused_attention_with_lse(q, k, v)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = (k5.flash_attention(q, k, v), k5.flash_attention(q, k, v, is_causal=True),
                        *k4.fused_attention_with_lse(q, k, v))
        for x in captured:
            x.zero_()
        graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


@pytest.mark.parametrize("denoiser,B,unet_impl", [("general", 4, "auto"), ("flagship", 2, "auto"),
                                                  ("flagship", 2, "pallas")])
def test_denoiser_graphs_replay_the_eager_sampler(dev, denoiser, B, unet_impl):
    """bf16 at the shipped widths: a 20-evaluation DPM-Solver++ sample
    through `Unit2MelSystem` at two frame lengths equals, bit for bit, the
    same sample through the eager module, with the same kernel launches
    counted; each shape warms up once and captures once, the other 18
    evaluations replay.  After an in-place optimizer step a replay equals a
    fresh eager evaluation; a parameter moved to new storage drops the
    graphs."""
    from latent_diffusion_speech_tpu_torch.utils import profiler

    cfg = Unit2MelConfig(denoiser=denoiser, attn_impl="pallas" if denoiser == "general" else "xla")
    sys_ = Unit2MelSystem(cfg, dtype=torch.bfloat16, device=dev, seed=0, unet_impl=unet_impl)
    eager = copy.copy(sys_.diffusion)
    eager.denoise_fn = lambda params, x, t: sys_.module.denoise(x, t)
    gen = torch.Generator(device=dev).manual_seed(0)
    profiler.disable()
    profiler.drain()
    for T in (96, 200):
        cond = torch.randn((B, T, cfg.n_hidden), generator=gen, device=dev).bfloat16()
        x0 = torch.randn((B, T, cfg.out_dims), generator=gen, device=dev)
        runs = []
        for diffusion, record in ((eager, False), (sys_.diffusion, True)):
            before = (k5.launches, k4.launches, k5.plain_routes)
            if record:
                profiler.enable()
            out = diffusion.sample(cond, method="dpm-solver", infer_speedup=50, x_init=x0)
            profiler.disable()
            runs.append((out, (k5.launches - before[0], k4.launches - before[1], k5.plain_routes - before[2])))
        (want, want_n), (got, got_n) = runs
        assert torch.equal(got, want)
        assert got_n == want_n and got_n[2] == 0 and got_n[0 if denoiser == "general" else 1] == 20 * 32
    counters = profiler.drain()[1]
    assert {k: counters.get(k, 0) for k in ("denoiser.graph_warmups", "denoiser.graph_captures",
                                            "denoiser.graph_replays", "denoiser.graph_bypasses")} == {
        "denoiser.graph_warmups": 2, "denoiser.graph_captures": 2, "denoiser.graph_replays": 2 * 20 - 2 * 2,
        "denoiser.graph_bypasses": 0}
    assert len(sys_.graphs) == 2

    unet = sys_.module.unet
    x = torch.randn((B, 200, cfg.out_dims + cfg.n_hidden), generator=gen, device=dev).bfloat16()
    t = torch.full((B,), 321.5, device=dev)
    opt = torch.optim.SGD(unet.parameters(), lr=1e-2)
    for p in unet.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
    opt.step()
    with torch.no_grad():
        sys_.graphs.check(unet)
        assert len(sys_.graphs) == 2
        assert torch.equal(sys_._denoise(None, x, t), sys_.module.denoise(x, t))
        w = next(unet.parameters())
        w.data = w.data.clone()
        sys_.graphs.check(unet)
        assert len(sys_.graphs) == 0


@pytest.mark.parametrize("what", ["pointer", "stride"])
def test_bf16_misaligned_views_raise(dev, what):
    """The tensor-core kernels copy 16 bytes at a time: a q whose data
    pointer or row stride is not 16-byte aligned raises ValueError."""
    width = 8 * 32 + (8 if what == "pointer" else 4)
    base = torch.zeros((1, 64, width), device=dev, dtype=torch.bfloat16)
    q = (base[..., 1:257] if what == "pointer" else base[..., :256]).view(1, 64, 8, 32)
    x = torch.zeros((1, 64, 8, 32), device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="16-byte"):
            k5.flash_attention(q, x, x)
        with pytest.raises(ValueError, match="16-byte"):
            k4.fused_attention(q, x, x)


def test_kmeans_predict_runs_k6_on_the_card(dev):
    """Stage 19's prediction with a codebook on the card: one K6 launch,
    the plain version's ids, the leading shape kept."""
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_predict

    gen = torch.Generator(device=dev).manual_seed(2)
    cb = torch.randn((4096, 1280), generator=gen, device=dev)
    x = cb[torch.randint(0, 4096, (2, 151), generator=gen, device=dev)] + 0.3 * torch.randn(
        (2, 151, 1280), generator=gen, device=dev)
    before = k6.launches
    ids = kmeans_predict(x, cb)
    assert k6.launches == before + 1 and ids.shape == (2, 151) and ids.device.type == "cuda"
    assert torch.equal(ids.reshape(-1), k6.kmeans_argmin_plain(x.reshape(-1, 1280), cb))


def test_units_encoder_on_the_card_matches_the_cpu(dev):
    """A small Whisper seeded on the card (no CPU init) and the same
    weights on the CPU: the same units from 44.1 kHz audio, f32, at atol
    2e-4 (the JAX package's Whisper bound)."""
    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.models.whisper import WhisperDims

    dims = WhisperDims(n_mels=80, n_audio_state=256, n_audio_head=4, n_audio_layer=2)
    card = UnitsEncoder(dims=dims, dtype=torch.float32, device=dev)
    assert next(card.model.model.parameters()).device.type == "cuda"
    cpu = UnitsEncoder(dims=dims, dtype=torch.float32, device="cpu")
    cpu.model.model.load_state_dict({k: v.cpu() for k, v in card.model.model.state_dict().items()})
    audio = torch.randn((1, 57330), generator=torch.Generator().manual_seed(0)) * 0.1
    got, ref = card.encode(audio, 44100), cpu.encode(audio, 44100)
    assert got.shape == ref.shape == (1, 20800 // 320, 256) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), ref, atol=2e-4, rtol=0)


def test_stage_17_step_on_the_card_equals_the_cpu_step(dev):
    """One step of stage 17's k-means (`quantize/kmeans.py::_assign_update`)
    at the shipped size, N = 8192 rows near a 4096 x 1280 codebook: K6's
    ids, the counts and the inertia's assignment equal the CPU step's, the
    centroids within 1e-5 of their scale (f32 sums of 8192 rows in other
    orders), and two card steps equal bit for bit (no atomics)."""
    from latent_diffusion_speech_tpu_torch.quantize import kmeans as km

    gen = torch.Generator().manual_seed(5)
    cb = torch.randn((4096, 1280), generator=gen)
    x = cb[torch.randint(0, 4096, (8192,), generator=gen)] + 0.3 * torch.randn((8192, 1280), generator=gen)
    counts = torch.randint(0, 8, (4096,), generator=gen).float()
    before = k6.launches
    card = [km._assign_update(cb.to(dev), counts.to(dev), x.to(dev)) for _ in range(2)]
    assert k6.launches == before + 2
    cpu = km._assign_update(cb, counts, x)
    for a, b in zip(*card):
        assert torch.equal(a, b)
    assert torch.equal(card[0][1].cpu(), cpu[1])
    torch.testing.assert_close(card[0][0].cpu(), cpu[0], atol=1e-5 * cpu[0].abs().max().item(), rtol=0)
    torch.testing.assert_close(card[0][2].cpu(), cpu[2], atol=0, rtol=1e-5)


def test_stage_17_fit_is_bitwise_repeatable_on_the_card(dev):
    """Two `kmeans_fit` runs with one seed on the card (k-means++ seeds from
    a generator on the card, 3 epochs of 2 minibatches): equal codebooks
    bit for bit, K6 launched once a step."""
    from latent_diffusion_speech_tpu_torch.quantize import kmeans as km

    gen = torch.Generator().manual_seed(6)
    data = (torch.randn((64, 96), generator=gen)[torch.randint(0, 64, (1100,), generator=gen)]
            + 0.1 * torch.randn((1100, 96), generator=gen)).numpy()
    before = k6.launches
    a, ia = km.kmeans_fit(data, k=64, epochs=3, batch_size=512, seed=2, device=dev)
    assert k6.launches == before + 6
    b, ib = km.kmeans_fit(data, k=64, epochs=3, batch_size=512, seed=2, device=dev)
    assert (a == b).all() and ia == ib


def test_vaegan_encoder_at_full_width_on_the_card_matches_the_cpu(dev):
    """The 44.1 kHz codec's encoder at full width (upsample_initial_channel
    512, 128 latent channels), seeded, f32 with TF32 off: `extract` on the
    card against the same weights on the CPU, m and logs within 1e-4 of
    their scale (f32 convolutions in other orders)."""
    from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN

    card = HifiVAEGAN.random_init(device=dev)
    cpu = HifiVAEGAN.random_init(device="cpu")
    audio = 0.3 * torch.randn((1, 44100), generator=torch.Generator().manual_seed(0))
    got, ref = card.extract(audio).cpu(), cpu.extract(audio)
    assert got.shape == ref.shape == (1, -(-44100 // 512), 256)
    torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
