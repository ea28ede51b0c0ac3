"""The port's diffusion stage against the JAX package.

Parameters move over with `convert.unit2mel_from_jax`; inputs and the
starting noise are made with numpy from a seed; f32 on the CPU.
Tolerances: schedule tables exact / rtol 1e-6; UNet eps atol 2e-4, rtol 1e-3
(tests/test_unit2mel_import.py); sampler trajectories (DPM-Solver++ and UniPC) and
`Unit2MelSystem.infer` atol/rtol 2e-3 (tests/test_diffusion.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion.samplers import dpmpp_sample as j_dpmpp_sample
from latent_diffusion_speech_tpu.models.diffusion.samplers import unipc_sample as j_unipc_sample
from latent_diffusion_speech_tpu.models.diffusion.schedule import DiffusionSchedule as JDiffusionSchedule
from latent_diffusion_speech_tpu.models.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.models.diffusion.samplers import dpmpp_sample, unipc_sample
from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import DiffusionSchedule, NoiseSchedule
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import timestep_embedding
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem

SMALL = dict(input_channel=12, n_spk=4, out_dims=6, n_hidden=10, block_out_channels=(16, 32),
             n_heads=2, timesteps=100, k_step=100, attn_impl="fused")


def _pair(gelu="auto"):
    jsys = JUnit2MelSystem(JUnit2MelConfig(gelu=gelu, **SMALL), seed=0)
    state = unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, jsys.params))
    return jsys, Unit2MelSystem(Unit2MelConfig(gelu=gelu, **SMALL), state_dict=state, device="cpu")


@pytest.fixture(scope="module")
def systems():
    return _pair()


def test_schedule_tables_match():
    ref = JDiffusionSchedule.linear(1000, 0.02)
    got = DiffusionSchedule.linear(1000, 0.02)
    for name in ("betas", "alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "posterior_log_variance_clipped", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_noise_schedule_matches():
    betas = JDiffusionSchedule.linear(1000, 0.02).betas
    ref, got = JNoiseSchedule(betas), NoiseSchedule(betas)
    t = np.linspace(1.0, 1e-3, 37).astype(np.float32)
    for fn in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std", "marginal_lambda"):
        np.testing.assert_allclose(getattr(got, fn)(torch.from_numpy(t)).numpy(),
                                   np.asarray(getattr(ref, fn)(jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.to_model_t(torch.tensor(0.5))), float(ref.to_model_t(0.5)),
                               rtol=1e-6)


def test_timestep_embedding_matches():
    from latent_diffusion_speech_tpu.models.diffusion.unet1d import timestep_embedding as j_emb

    t = np.array([0.0, 3.5, 999.0], np.float32)
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), 16).numpy(),
                               np.asarray(j_emb(jnp.asarray(t), 16)), atol=1e-5)


@pytest.mark.parametrize("gelu", ["auto", "tanh"])
def test_unet_eps_matches(systems, rng, gelu):
    jsys, sys_ = systems if gelu == "auto" else _pair(gelu)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    t = np.array([3, 711], np.int32)
    denoise = jax.jit(lambda p, x, t: jsys.module.apply({"params": p}, x, t, method=jsys.module.denoise))
    ref = denoise(jsys.params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = sys_.module.denoise(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("steps", [5, 20])
def test_dpmpp_trajectory_matches(rng, steps):
    betas = JDiffusionSchedule.linear(1000, 0.02).betas
    x0 = rng.standard_normal((2, 9, 4)).astype(np.float32)

    def j_eps(x, t):
        return jnp.tanh(x) * jnp.cos(t.astype(jnp.float32) / 1000.0)[:, None, None]

    def t_eps(x, t):
        return torch.tanh(x) * torch.cos(t.float() / 1000.0)[:, None, None]

    ref = j_dpmpp_sample(j_eps, JNoiseSchedule(betas), jnp.asarray(x0), steps=steps, order=2)
    got = dpmpp_sample(t_eps, NoiseSchedule(betas), torch.from_numpy(x0), steps=steps, order=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("variant", ["bh1", "bh2"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("steps", [1, 2, 3, 5, 10, 20])
def test_unipc_trajectory_matches(rng, steps, order, variant):
    """UniPC over a fixed linear eps_fn, from the same x_init."""
    betas = JDiffusionSchedule.linear(1000, 0.02).betas
    x0 = rng.standard_normal((2, 9, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32) / 2

    def j_eps(x, t):
        return (x @ jnp.asarray(w)) * (1.0 - t.astype(jnp.float32) / 2000.0)[:, None, None]

    def t_eps(x, t):
        return (x @ torch.from_numpy(w)) * (1.0 - t.float() / 2000.0)[:, None, None]

    ref = j_unipc_sample(j_eps, JNoiseSchedule(betas), jnp.asarray(x0), steps=steps, order=order,
                         variant=variant)
    got = unipc_sample(t_eps, NoiseSchedule(betas), torch.from_numpy(x0), steps=steps, order=order,
                       variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_unipc_makes_steps_model_calls():
    betas = JDiffusionSchedule.linear(1000, 0.02).betas
    calls = []

    def eps(x, t):
        calls.append(float(t[0]))
        return 0.1 * x

    unipc_sample(eps, NoiseSchedule(betas), torch.ones((1, 3, 2)), steps=7)
    assert len(calls) == 7 and calls == sorted(calls, reverse=True)


def test_unit2mel_infer_defaults_match(systems, rng):
    """Both packages' `infer` on their defaults (UniPC, speedup 10) from the
    same x_init."""
    jsys, sys_ = systems
    units = rng.standard_normal((2, 11, 12)).astype(np.float32)
    spk = np.array([[2], [4]], np.int32)
    x0 = rng.standard_normal((2, 11, 6)).astype(np.float32)
    infer = jax.jit(lambda p, u, s, x: jsys.infer(u, jax.random.PRNGKey(0), spk_id=s, params=p, x_init=x))
    ref = infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(x0))
    got = sys_.infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(), x_init=torch.from_numpy(x0))
    assert got.shape == (2, 11, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_unit2mel_infer_matches(systems, rng):
    """condition -> pad to the UNet grid -> 10-step DPM-Solver++ -> crop,
    from the same x_init."""
    jsys, sys_ = systems
    units = rng.standard_normal((2, 13, 12)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    x0 = rng.standard_normal((2, 13, 6)).astype(np.float32)
    infer = jax.jit(lambda p, u, s, x: jsys.infer(u, jax.random.PRNGKey(0), spk_id=s, params=p,
                                                  method="dpm-solver", infer_speedup=10, x_init=x))
    ref = infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(x0))
    got = sys_.infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(),
                     method="dpm-solver", infer_speedup=10, x_init=torch.from_numpy(x0))
    assert got.shape == (2, 13, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_unported_samplers_raise(systems):
    _, sys_ = systems
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sys_.infer(torch.zeros((1, 8, 12)), method="ddim")
