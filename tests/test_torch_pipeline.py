"""The port's TTS serve path as a whole against the JAX package.

Tiny models in the style of tests/test_e2e.py; the JAX pipeline's weights
move over with `convert.*_from_jax`.  f32 on the CPU.  Greedy tokens must be
identical; the waveform from the same tokens and the same x_init is held
at atol/rtol 2e-3 (the sampler tolerance of tests/test_diffusion.py: the
waveform is the 20-step sampler's output through the vocoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.infer import TTSPipeline as JTTSPipeline
from latent_diffusion_speech_tpu.models.diffusion import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.models.lm import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

UNIT_DIM = 16
VAEGAN = dict(
    sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
)
U2M = dict(input_channel=UNIT_DIM, n_spk=4, out_dims=6, n_hidden=8,
           block_out_channels=(8, 8), n_heads=2, timesteps=50, k_step=50)
STACK = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16)
LM = dict(semantic_kmeans_num=32, n_spk=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes():
    jdiff = JUnit2MelSystem(JUnit2MelConfig(**U2M))
    jvoc = JVocoder("hifi-vaegan")
    jvoc.vocoder = HifiVAEGAN.random_init(JVAEGANConfig(**VAEGAN))
    jlm = JRoformerSystem(JRoformerConfig(encoder=JStackConfig(**STACK), decoder=JStackConfig(**STACK), **LM))
    codebook = np.random.default_rng(0).standard_normal((32, UNIT_DIM)).astype(np.float32)
    jpipe = JTTSPipeline(jdiff, jvoc, lm=jlm, codebook=codebook)

    pipe = TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=convert.unit2mel_from_jax(_np(jdiff.params)),
                       device="cpu"),
        Vocoder("hifi-vaegan", VAEGANConfig(**VAEGAN),
                state_dict=convert.generator_from_jax(_np(jvoc.vocoder.generator_params)), device="cpu"),
        lm=RoformerSystem(RoformerConfig(encoder=StackConfig(**STACK), decoder=StackConfig(**STACK), **LM),
                          state_dict=convert.roformer_from_jax(_np(jlm.params)), device="cpu"),
        codebook=codebook,
    )
    return jpipe, pipe


def test_same_phones_same_greedy_tokens(pipes, rng):
    jpipe, pipe = pipes
    phones = rng.integers(1, 50, (1, 6)).astype(np.int32)
    tones = rng.integers(0, 6, (1, 6)).astype(np.int32)
    ref_t, ref_l = jpipe.lm.generate(phones, tones, spk_id=2, max_length=12, do_sample=False)
    got_t, got_l = pipe.lm.generate(phones, tones, spk_id=2, max_length=12, do_sample=False)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


def test_same_tokens_and_x_init_same_wav(pipes, rng):
    """units -> pad to bucket -> condition -> 10-step DPM-Solver++ -> vocoder
    -> crop, with the same starting noise in both packages."""
    jpipe, pipe = pipes
    tokens = rng.integers(0, 32, 10).astype(np.int32)
    x0 = rng.standard_normal((1, 64, 6)).astype(np.float32)  # bucket 64
    jdiff, jvoc = jpipe.diffusion, jpipe.vocoder.vocoder

    @jax.jit
    def serve(dparams, gparams, units, x_init):
        padded = jnp.pad(units, ((0, 0), (0, 54), (0, 0)), mode="edge")
        cond = jdiff.condition(padded, spk_id=jnp.full((1, 1), 3), params=dparams)
        mel = jdiff.diffusion.sample(dparams, cond, jax.random.PRNGKey(0), method="dpm-solver",
                                     infer_speedup=5, x_init=x_init)
        return jvoc.generator.apply({"params": gparams}, mel)[:, : 10 * 8]

    ref = np.asarray(serve(jdiff.params, jvoc.generator_params, jpipe.semantic_to_units(tokens),
                           jnp.asarray(x0)))
    got = pipe.infer(pipe.semantic_to_units(tokens), spk_id=3, infer_speedup=5,
                     x_init=torch.from_numpy(x0))
    assert got.shape == ref.shape == (1, 80)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=2e-3)


def test_tts_from_phones_runs_sampled(pipes, rng):
    _, pipe = pipes
    phones = rng.integers(1, 50, 6).astype(np.int32)
    tones = rng.integers(0, 6, 6).astype(np.int32)
    wav, sr = pipe.tts_from_phones(phones, tones, spk_id=2, infer_speedup=25, max_length=12)
    assert sr == 8000 and wav.ndim == 1 and np.isfinite(wav).all()
    assert len(wav) % 8 == 0 and 0 < len(wav) <= 12 * 8


def _fake_phones(self, text, language="ZH"):
    r = np.random.default_rng(len(text))
    n = 4 + len(text) % 3
    return r.integers(1, 50, n).astype(np.int32), r.integers(0, 6, n).astype(np.int32)


class _Spy:
    """Records the batch size of each call, then calls through."""

    def __init__(self, fn):
        self.fn, self.batches = fn, []

    def __call__(self, x, *a, **kw):
        self.batches.append(int(np.shape(x)[0]))
        return self.fn(x, *a, **kw)


@pytest.mark.parametrize("batch_bucket,lm_batch", [(True, 4), (False, 3)])
def test_tts_batch_pads_batch_to_pow2(pipes, monkeypatch, batch_bucket, lm_batch):
    """B=3 pads to 4 in the LM decode and in the (single) diffusion length
    bucket, pad outputs dropped; batch_bucket=False keeps exact sizes."""
    _, pipe = pipes
    monkeypatch.setattr(type(pipe), "text_to_phones", _fake_phones)
    gen_spy, inf_spy = _Spy(pipe.lm.generate), _Spy(pipe.infer)
    monkeypatch.setattr(pipe.lm, "generate", gen_spy)
    monkeypatch.setattr(pipe, "infer", inf_spy)
    outs = pipe.tts_batch(["a", "bb", "ccc"], spk_ids=[1, 2, 3], infer_speedup=25, max_length=8,
                          batch_bucket=batch_bucket)
    assert gen_spy.batches == [lm_batch]
    assert inf_spy.batches == [lm_batch]  # every item <= 8 tokens: one bucket
    assert len(outs) == 3
    for wav, sr in outs:
        assert sr == 8000 and np.isfinite(wav).all() and len(wav) > 0


def test_tts_batch_crops_per_item(pipes, monkeypatch):
    """Each item's waveform is cropped to its own token count * hop, and
    items of different length buckets run as separate diffusion calls."""
    _, pipe = pipes
    monkeypatch.setattr(type(pipe), "text_to_phones", _fake_phones)
    K = pipe.lm.cfg.semantic_kmeans_num

    def fake_generate(phones, tones, **kw):
        toks = np.full((2, 80), K + 2, np.int32)  # PAD
        toks[0, :3] = [1, 2, 3]
        toks[1, :70] = np.arange(70) % K
        return torch.from_numpy(toks), torch.tensor([3, 70], dtype=torch.int32)

    monkeypatch.setattr(pipe.lm, "generate", fake_generate)
    inf_spy = _Spy(pipe.infer)
    monkeypatch.setattr(pipe, "infer", inf_spy)
    outs = pipe.tts_batch(["ab", "abcd"], spk_ids=[1, 2], infer_speedup=25)
    assert len(outs[0][0]) == 3 * 8
    assert len(outs[1][0]) == 70 * 8
    assert inf_spy.batches == [1, 1]  # buckets 64 and 128, one call each
