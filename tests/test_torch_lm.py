"""The port's RoFormer LM and sampling against the JAX package.

Both packages get the same parameters (flax init, moved over with
`convert.roformer_from_jax`) and the same inputs, made with numpy from a
seed; everything runs in f32 on the CPU.  Tolerances: logits and encoder
states atol 2e-4, rtol 1e-3 (tests/test_lm.py's HF parity); greedy tokens
and lengths must be identical to the JAX scan path and to the JAX K1 kernel
(`roformer_decode_pallas` in interpret mode, as tests/test_pallas_ar_decode.py
runs it).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.models.lm.sampling import SamplingConfig as JSamplingConfig
from latent_diffusion_speech_tpu.models.lm.sampling import process_logits as j_process_logits
from latent_diffusion_speech_tpu.ops.pallas.ar_decode import roformer_decode_pallas
from latent_diffusion_speech_tpu_torch.convert import roformer_from_jax
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode

ATOL, RTOL = 2e-4, 1e-3
STACK = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128)


@pytest.fixture(scope="module")
def lms():
    jcfg = JRoformerConfig(
        encoder=JStackConfig(num_hidden_layers=2, **STACK),
        decoder=JStackConfig(num_hidden_layers=1, **STACK),
        semantic_kmeans_num=300, n_spk=4,
    )
    jlm = JRoformerSystem(jcfg, dtype=jnp.float32, seed=0)
    cfg = RoformerConfig(
        encoder=StackConfig(num_hidden_layers=2, **STACK),
        decoder=StackConfig(num_hidden_layers=1, **STACK),
        semantic_kmeans_num=300, n_spk=4,
    )
    state = roformer_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params))
    return jlm, RoformerSystem(cfg, state_dict=state, device="cpu")


def _inputs(rng, B, L):
    phones = rng.integers(1, 60, (B, L)).astype(np.int32)
    tones = rng.integers(0, 5, (B, L)).astype(np.int32)
    return phones, tones, np.ones_like(phones)


def _jax_k1(jlm, phones, tones, spk, mask, sampling):
    enc = jlm.module.apply({"params": jlm.params}, phones, tones, spk, mask, method=jlm.module.encode)
    kvs = jlm.module.apply({"params": jlm.params}, enc, method=jlm.module.compute_cross_kv)
    cross_len = mask.sum(-1).astype(np.int32)
    return roformer_decode_pallas(jlm.params, jlm.cfg, sampling, kvs, cross_len, 0,
                                  dtype=jnp.float32, interpret=True)


def test_encoder_matches(lms, rng):
    jlm, lm = lms
    phones, tones, spk = _inputs(rng, 2, 9)
    mask = np.ones_like(phones)
    mask[1, 6:] = 0
    ref = jlm.module.apply({"params": jlm.params}, phones, tones, spk, mask, method=jlm.module.encode)
    with torch.no_grad():
        got = lm.module.encode(*(torch.from_numpy(a).long() for a in (phones, tones, spk, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_decode_step_logits_match(lms, rng):
    """Teacher-forced decode steps over the KV cache give the same logits."""
    jlm, lm = lms
    B, L, S = 2, 7, 5
    phones, tones, spk = _inputs(rng, B, L)
    toks = rng.integers(0, 300, (B, S)).astype(np.int32)
    jm, jp = jlm.module, {"params": jlm.params}
    enc = jm.apply(jp, phones, tones, spk, None, method=jm.encode)
    kvs = jm.apply(jp, enc, method=jm.compute_cross_kv)
    caches = jm.apply(jp, B, S, method=jm.init_cache)
    with torch.no_grad():
        tenc = lm.module.encode(*(torch.from_numpy(a).long() for a in (phones, tones, spk)))
        tkvs = lm.module.compute_cross_kv(tenc)
        tcaches = lm.module.init_cache(B, S)
        for pos in range(S):
            ref, caches = jm.apply(jp, jnp.asarray(toks[:, pos]), pos, caches, enc, None, kvs,
                                   method=jm.decode_step)
            got, tcaches = lm.module.decode_step(torch.from_numpy(toks[:, pos]).long(), pos,
                                                 tcaches, None, None, tkvs)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


PROCESSORS = {
    "repetition": dict(do_sample=False, repetition_penalty=1.3),
    "ban": dict(do_sample=False, repetition_penalty=1.0, ban_until=7),
    "end_gate": dict(do_sample=False, repetition_penalty=1.0, end_gate_threshold=1e-3, eos_token_id=3),
    "temperature": dict(do_sample=True, temperature=0.7, top_k=0, top_p=1.0, repetition_penalty=1.0),
    "top_k": dict(do_sample=True, top_k=5, top_p=1.0, repetition_penalty=1.0),
    "top_k_top_p": dict(do_sample=True, top_k=6, top_p=0.6),
    "top_p": dict(do_sample=True, top_k=0, top_p=0.7, repetition_penalty=1.0),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_process_logits_matches(name, rng):
    kw = PROCESSORS[name]
    logits = (rng.standard_normal((3, 40)) * 3).astype(np.float32)
    if name == "end_gate":
        logits[0, 3] = 12.0  # the gate fires for row 0 only
    seen = rng.random((3, 40)) < 0.2
    ref = np.asarray(j_process_logits(jnp.asarray(logits), jnp.asarray(seen), JSamplingConfig(**kw)))
    got = process_logits(torch.from_numpy(logits), torch.from_numpy(seen), SamplingConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-6, rtol=1e-6)


def _greedy_cfg(lm_cfg, N, **kw):
    return JSamplingConfig(
        max_new_tokens=N, do_sample=False, eos_token_id=lm_cfg.semantic_eos,
        pad_token_id=lm_cfg.semantic_pad, bos_token_id=lm_cfg.semantic_bos, **kw,
    )


@pytest.mark.parametrize("case", ["full", "cross_len_mask", "end_gate", "end_gate_at_once"])
def test_greedy_generate_matches_scan_and_k1(lms, rng, case):
    """Greedy tokens and lengths equal the JAX scan path and JAX K1."""
    jlm, lm = lms
    B, L, N = 2, 11, 20
    phones, tones, spk = _inputs(rng, B, L)
    mask = np.ones_like(phones)
    gate = None
    if case == "cross_len_mask":
        mask[0, 7:] = 0
        mask[1, 4:] = 0
    if case == "end_gate":
        gate = 0.02
    if case == "end_gate_at_once":
        gate = 1e-9  # fires at step 0: EOS, length 1, PAD after
    ref_t, ref_l = jlm.generate(phones, tones, spk_id=spk, attention_mask=mask, max_length=N,
                                do_sample=False, end_gate_threshold=gate,
                                rng=jax.random.PRNGKey(0))
    k1_t, k1_l = _jax_k1(jlm, phones, tones, spk, mask,
                         _greedy_cfg(jlm.cfg, N, end_gate_threshold=gate))
    np.testing.assert_array_equal(np.asarray(k1_t), np.asarray(ref_t))
    got_t, got_l = lm.generate(phones, tones, spk_id=spk, attention_mask=mask, max_length=N,
                               do_sample=False, end_gate_threshold=gate)
    assert got_t.dtype == torch.int32 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(k1_l))
    if case == "end_gate_at_once":
        assert (got_l.numpy() == 1).all() and (got_t.numpy()[:, 0] == lm.cfg.semantic_eos).all()
        assert (got_t.numpy()[:, 1:] == lm.cfg.semantic_pad).all()
    if case == "cross_len_mask":
        # the masked encoder rows matter: unmasked decoding differs
        full_t, _ = lm.generate(phones, tones, spk_id=spk, max_length=N, do_sample=False)
        assert not np.array_equal(full_t.numpy(), got_t.numpy())


@pytest.mark.parametrize("top_k,top_p", [(5, 0.8), (3, 1.0), (0, 0.7)])
def test_sampled_tokens_stay_in_processed_support(lms, rng, top_k, top_p):
    """Sampling draws other random numbers than JAX, so it is held to the
    support: teacher-forcing the sampled tokens, each one has a finite
    processed logit at its step; PAD follows EOS; lengths count the EOS."""
    # a copy with a raised EOS bias, so that streams end inside N steps
    lm = copy.deepcopy(lms[1])
    with torch.no_grad():
        lm.module.head_bias[lm.cfg.semantic_eos] += 6.0
    B, L, N = 3, 8, 24
    phones, tones, spk = _inputs(rng, B, L)
    gen = torch.Generator().manual_seed(1)
    toks, lens = lm.generate(phones, tones, spk_id=spk, max_length=N, top_k=top_k, top_p=top_p,
                             generator=gen)
    cfg = lm.cfg
    sampling = SamplingConfig(max_new_tokens=N, top_k=top_k, top_p=top_p,
                              eos_token_id=cfg.semantic_eos, pad_token_id=cfg.semantic_pad,
                              bos_token_id=cfg.semantic_bos)
    m = lm.module
    with torch.no_grad():
        enc = m.encode(*(torch.from_numpy(a).long() for a in (phones, tones, spk)))
        kvs = m.compute_cross_kv(enc)
        caches = m.init_cache(B, N)
        rep = torch.zeros((B, cfg.semantic_vocab_size), dtype=torch.bool)
        rep[:, cfg.semantic_bos] = True
        prev = torch.full((B,), cfg.semantic_bos)
        for pos in range(N):
            logits, caches = m.decode_step(prev, pos, caches, None, None, kvs)
            processed = process_logits(logits, rep, sampling)
            cur = toks[:, pos].long()
            for b in range(B):
                if pos < int(lens[b]):
                    assert torch.isfinite(processed[b, cur[b]]), (b, pos)
                else:
                    assert int(cur[b]) == cfg.semantic_pad
            rep[torch.arange(B), cur] = True
            prev = cur
    for b in range(B):
        n = int(lens[b])
        assert n == N or int(toks[b, n - 1]) == cfg.semantic_eos
    assert int(lens.min()) < N, "no stream reached EOS: the length/PAD rules went untested"


def test_k1_wrapper_raises_off_cpu_and_cuda():
    """The wrapper runs the plain loop only for a model on the CPU; any
    other device gets the kernel or an error, never the plain loop."""
    meta = torch.empty((1, 4, 4, 16), device="meta")
    model = type("M", (), {"head_bias": torch.empty(1, device="meta")})()
    with pytest.raises(RuntimeError, match="no kernel"):
        ar_decode.roformer_decode(model, SamplingConfig(), [(meta, meta)], torch.ones(1))
