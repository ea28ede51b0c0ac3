"""The general denoiser (`Unit2MelConfig(denoiser="general")`) on the port's
serve and training paths, against the JAX package.

Parameters move over with `convert.unit2mel_from_jax`; inputs and the
starting noise are made with numpy from a seed; f32 on the CPU.  The port
samples with attn_impl="pallas" (the K5 plain version here); the JAX
reference runs attn_impl="xla", which in f32 agrees with its K5 kernel
(interpret mode) to ~1e-6, far inside the sampler tolerance.  Tolerances:
the denoiser's eps atol 2e-4 / rtol 1e-3 (tests/test_unit2mel_import.py);
the 20-step DPM-Solver++ sample and the pipeline's waveform atol/rtol 2e-3
(tests/test_diffusion.py); the loss rtol 1e-5 and every gradient atol 1e-5
/ rtol 1e-4 (tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.infer import TTSPipeline as JTTSPipeline
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.models.lm import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d_condition import UNet1DCondition
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

SMALL = dict(input_channel=12, n_spk=4, out_dims=6, n_hidden=10, block_out_channels=(16, 24, 32), n_layers=1,
             n_heads=2, timesteps=100, k_step=100, denoiser="general")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def systems():
    jsys = JUnit2MelSystem(JUnit2MelConfig(attn_impl="xla", **SMALL), seed=0)
    state = convert.unit2mel_from_jax(_np(jsys.params))
    return jsys, state


def _port(state, attn_impl="pallas"):
    return Unit2MelSystem(Unit2MelConfig(attn_impl=attn_impl, **SMALL), state_dict=state, device="cpu")


def test_converter_takes_the_general_tree(systems):
    """Every leaf of the flax tree lands on a parameter of the same shape,
    and the denoiser is the general one."""
    _, state = systems
    sys_ = _port(state)
    mine = sys_.module.state_dict()
    assert set(mine) == set(state)
    assert all(mine[k].shape == state[k].shape for k in state)
    assert isinstance(sys_.module.unet, UNet1DCondition)
    assert "unet.down_blocks_0.attentions_0.transformer_blocks_0.ff.net_0.proj.weight" in state
    assert "unet.down_blocks_0.downsamplers_0.conv.weight" in state


@pytest.mark.parametrize("attn_impl", ["xla", "pallas", "fused"])
def test_denoiser_eps_matches(systems, rng, attn_impl):
    jsys, state = systems
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    t = np.array([3, 711], np.int32)
    denoise = jax.jit(lambda p, x, t: jsys.module.apply({"params": p}, x, t, method=jsys.module.denoise))
    ref = denoise(jsys.params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = _port(state, attn_impl).module.denoise(torch.from_numpy(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_infer_20_steps_matches(systems, rng):
    """condition -> pad to the UNet grid -> 20-step DPM-Solver++ -> crop,
    from the same x_init."""
    jsys, state = systems
    units = rng.standard_normal((2, 13, 12)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    x0 = rng.standard_normal((2, 13, 6)).astype(np.float32)
    infer = jax.jit(lambda p, u, s, x: jsys.infer(u, jax.random.PRNGKey(0), spk_id=s, params=p,
                                                  method="dpm-solver", infer_speedup=5, x_init=x))
    ref = infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(x0))
    got = _port(state).infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(), method="dpm-solver",
                             infer_speedup=5, x_init=torch.from_numpy(x0))
    assert got.shape == (2, 13, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_loss_and_gradients_match_jax_with_xla(systems, rng):
    """The general denoiser trains under attn_impl='xla' (as the JAX package
    does): from the same weights, t and noise, the loss and every gradient."""
    jsys, state = systems
    units = rng.standard_normal((2, 13, 12)).astype(np.float32)
    spec = rng.standard_normal((2, 13, 6)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    aug = rng.standard_normal((2, 1)).astype(np.float32)
    t = np.array([3, 71], np.int32)
    noise = rng.standard_normal((2, 13, 6)).astype(np.float32)

    def j_loss(params, units, spec, spk, aug, t, noise):
        d = jsys.diffusion
        cond = jsys.condition(units, None, spk, aug, params=params)
        x_noisy, cond, T = d._pad(d.q_sample(d.norm_spec(spec), t, noise), cond)
        eps = d._eps_fn(params, cond)(x_noisy, t)[:, :T]
        return jnp.mean((noise - eps) ** 2)

    ref, j_grads = jax.jit(jax.value_and_grad(j_loss))(
        jsys.params, *(jnp.asarray(a) for a in (units, spec, spk, aug, t, noise)))
    sys_ = _port(state, "xla")
    sys_.module.train()
    d = sys_.diffusion
    tt, tnoise = torch.from_numpy(t).long(), torch.from_numpy(noise)
    cond = sys_.module.condition(torch.from_numpy(units), None, torch.from_numpy(spk).long(), torch.from_numpy(aug))
    x_noisy, cond, T = d._pad(d.q_sample(d.norm_spec(torch.from_numpy(spec)), tt, tnoise), cond)
    eps = d.denoise_fn(None, torch.cat([x_noisy, cond], dim=-1), tt)[:, :T]
    loss = ((tnoise - eps) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    want = convert.unit2mel_from_jax(_np(j_grads))
    got = {n: p.grad for n, p in sys_.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_loss_raises_with_k5(systems):
    """K5 has no backward: the training loss under attn_impl='pallas' raises."""
    _, state = systems
    sys_ = _port(state)
    with pytest.raises(RuntimeError, match="no backward"):
        sys_.loss(torch.zeros((1, 8, 12)), torch.zeros((1, 8, 6)), torch.Generator().manual_seed(0),
                  spk_id=torch.ones((1, 1), dtype=torch.long))


def test_fused_unet_kernel_rejects_the_general_layout(systems):
    _, state = systems
    with pytest.raises(ValueError, match="flagship"):
        Unit2MelSystem(Unit2MelConfig(attn_impl="pallas", **SMALL), state_dict=state, device="cpu",
                       unet_impl="pallas")


UNIT_DIM = 16
VAEGAN = dict(
    sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
)
U2M = dict(input_channel=UNIT_DIM, n_spk=4, out_dims=6, n_hidden=8, block_out_channels=(8, 16), n_heads=2,
           timesteps=50, k_step=50, denoiser="general")
STACK = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16)
LM = dict(semantic_kmeans_num=32, n_spk=4)


def test_tts_from_phones_matches_jax_pipeline(rng):
    """The serve entry point with the general denoiser under K5: with top_k=1
    both LMs pick the same tokens; from the same x_init the waveform is the
    JAX pipeline's (units -> bucket -> condition -> 10-step DPM-Solver++ ->
    vocoder -> crop)."""
    jdiff = JUnit2MelSystem(JUnit2MelConfig(**U2M))
    jvoc = JVocoder("hifi-vaegan")
    jvoc.vocoder = HifiVAEGAN.random_init(JVAEGANConfig(**VAEGAN))
    jlm = JRoformerSystem(JRoformerConfig(encoder=JStackConfig(**STACK), decoder=JStackConfig(**STACK), **LM))
    codebook = np.random.default_rng(0).standard_normal((32, UNIT_DIM)).astype(np.float32)
    jpipe = JTTSPipeline(jdiff, jvoc, lm=jlm, codebook=codebook)
    pipe = TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(attn_impl="pallas", **U2M),
                       state_dict=convert.unit2mel_from_jax(_np(jdiff.params)), device="cpu"),
        Vocoder("hifi-vaegan", VAEGANConfig(**VAEGAN),
                state_dict=convert.generator_from_jax(_np(jvoc.vocoder.generator_params)), device="cpu"),
        lm=RoformerSystem(RoformerConfig(encoder=StackConfig(**STACK), decoder=StackConfig(**STACK), **LM),
                          state_dict=convert.roformer_from_jax(_np(jlm.params)), device="cpu"),
        codebook=codebook,
    )
    phones = rng.integers(1, 50, 6).astype(np.int32)
    tones = rng.integers(0, 6, 6).astype(np.int32)
    tokens = np.asarray(jpipe.generate_semantic(phones, tones, spk_id=2, max_length=12, top_k=1))
    assert len(tokens) > 0
    x0 = torch.from_numpy(rng.standard_normal((1, 64, 6)).astype(np.float32))  # bucket 64

    @jax.jit
    def serve(dparams, gparams, units, x_init):
        padded = jnp.pad(units, ((0, 0), (0, 64 - units.shape[1]), (0, 0)), mode="edge")
        cond = jdiff.condition(padded, spk_id=jnp.full((1, 1), 2), params=dparams)
        mel = jdiff.diffusion.sample(dparams, cond, jax.random.PRNGKey(0), method="dpm-solver",
                                     infer_speedup=5, x_init=x_init)
        return jvoc.vocoder.generator.apply({"params": gparams}, mel)[:, : len(tokens) * 8]

    ref = np.asarray(serve(jdiff.params, jvoc.vocoder.generator_params, jpipe.semantic_to_units(tokens),
                           jnp.asarray(x0.numpy())))[0]
    real_infer = pipe.diffusion.infer
    pipe.diffusion.infer = lambda *a, **kw: real_infer(*a, **{**kw, "x_init": x0})
    got, sr = pipe.tts_from_phones(phones, tones, spk_id=2, infer_speedup=5, max_length=12, top_k=1)
    assert sr == 8000 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)
