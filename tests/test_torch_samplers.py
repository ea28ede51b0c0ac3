"""The port's samplers against the JAX package's, function by function, and
`GaussianDiffusion.sample` for every method name.

The same numpy-seeded x_T goes through each JAX sampler and its port with
the same `NoiseSchedule` / `DiffusionSchedule` and a deterministic toy
eps_fn written in both frameworks.  DDPM also needs the same per-step
noise: the test replaces each package's noise draw with one that hands out
the same numpy arrays, step by step.  `GaussianDiffusion.sample` runs on
the tiny `Unit2Mel` of tests/test_torch_pipeline.py with the JAX weights
carried across by `convert.unit2mel_from_jax` and the same x_init.

Tolerance: f32, atol/rtol 2e-3 (the sampler tolerance of
tests/test_diffusion.py) for whole trajectories through a UNet; the toy
trajectories (DDIM, PLMS, and the continuous solvers over a bounded eps)
hold at atol/rtol 1e-4, and `singlestep_orders` must be equal.  One
exception: the adaptive DPM-Solver++ through the UNet.  Its step-size
controller feeds each step's error norm, a difference of two solutions,
back into the next step, so f32 rounding grows until an accept/reject
decision flips, and two runs end on different step sequences: the JAX
package's own jitted and eager runs of that case differ by 0.055 (max abs,
outputs up to 4.0), 0.98 in the sampler's own error norm (the RMS of the
difference over max(atol, rtol |x|), atol 0.0078, rtol 0.05: its
defaults, where one step is accepted at <= 1).  The port is held there to
that norm <= 2: two solutions each within the controller's tolerance.
The toy case checks the loop step for step: the same model-evaluation
times and count, and the same result at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion import samplers as J
from latent_diffusion_speech_tpu.models.diffusion.schedule import DiffusionSchedule as JDiffusionSchedule
from latent_diffusion_speech_tpu.models.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.models.diffusion import samplers as P
from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import DiffusionSchedule, NoiseSchedule
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem

TOY = dict(atol=1e-4, rtol=1e-4)
UNET = dict(atol=2e-3, rtol=2e-3)
ADAPTIVE = "the adaptive sampler's error norm <= 2"
BETAS = JDiffusionSchedule.linear(1000, 0.02).betas
# the tiny Unit2Mel of tests/test_torch_pipeline.py
U2M = dict(input_channel=16, n_spk=4, out_dims=6, n_hidden=8, block_out_channels=(8, 8), n_heads=2,
           timesteps=50, k_step=50)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread.  Under the parallel test run every
    worker's default thread pool spins against the others' for each small
    op, which made these tests 10-200x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adaptive_norm(got, ref, atol=0.0078, rtol=0.05):
    """dpmpp_adaptive_sample's error norm (its default atol / rtol) of
    got - ref: the largest per-item RMS of the scaled difference."""
    err = (got - ref) / np.maximum(atol, rtol * np.abs(ref))
    return float(np.sqrt((err.reshape(len(err), -1) ** 2).mean(-1)).max())


def _toy(rng):
    """A bounded, t-dependent eps in both frameworks (the trajectories stay
    O(1), so the tolerance is not eaten by growth)."""
    w = rng.standard_normal((4, 4)).astype(np.float32) / 2

    def j_eps(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) * jnp.cos(t.astype(jnp.float32) / 1000.0)[:, None, None]

    def t_eps(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) * torch.cos(t.float() / 1000.0)[:, None, None]

    return j_eps, t_eps


def _x(rng):
    return rng.standard_normal((2, 9, 4)).astype(np.float32)


class _SameNoise:
    """Hands out the same numpy noise, in order, to both packages' draws.

    The JAX draw runs inside `lax.scan` under jit, so it cannot count its
    calls: it finds its key in the table of the subkeys the JAX loop splits
    off, one a step (NaN noise for a key not in the table, so a mismatch
    fails the comparison rather than passing unnoticed)."""

    def __init__(self, rng, shape, keys):
        self.draws = np.stack([rng.standard_normal(shape).astype(np.float32) for _ in keys])
        self.keys = jnp.stack(keys)
        self.t = 0

    @staticmethod
    def ddpm_keys(rng, n):
        """The subkeys `ddpm_sample(rng=...)` draws its n steps' noise with."""
        keys = []
        for _ in range(n):
            rng, sub = jax.random.split(rng)
            keys.append(sub)
        return keys

    def jax_normal(self, key, shape, dtype=jnp.float32):
        hit = jnp.all(self.keys == key[None], axis=-1)
        noise = jnp.asarray(self.draws)[jnp.argmax(hit)]
        return jnp.where(jnp.any(hit), noise, jnp.nan).astype(dtype)

    def torch_normal(self, x, generator):
        out = torch.from_numpy(self.draws[self.t].copy()).to(x.dtype)
        self.t += 1
        return out


def test_ddpm_matches_with_the_same_noise(rng, monkeypatch):
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    t_max = 100
    key = jax.random.PRNGKey(0)
    noise = _SameNoise(rng, x0.shape, _SameNoise.ddpm_keys(key, t_max))
    monkeypatch.setattr(jax.random, "normal", noise.jax_normal)
    monkeypatch.setattr(P, "_normal", noise.torch_normal)
    ref = J.ddpm_sample(j_eps, JDiffusionSchedule.linear(t_max), jnp.asarray(x0), t_max, key)
    got = P.ddpm_sample(t_eps, DiffusionSchedule.linear(t_max), torch.from_numpy(x0), t_max)
    assert noise.t == t_max  # one draw a step
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)


@pytest.mark.parametrize("speedup", [1, 10, 25])
@pytest.mark.parametrize("name", ["ddim_sample", "plms_sample"])
def test_ddim_and_plms_match(rng, name, speedup):
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    ref = getattr(J, name)(j_eps, JDiffusionSchedule.linear(100), jnp.asarray(x0), 100, speedup)
    got = getattr(P, name)(t_eps, DiffusionSchedule.linear(100), torch.from_numpy(x0), 100, speedup)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)


def test_plms_makes_one_extra_model_call():
    calls = []

    def eps(x, t):
        calls.append(int(t[0]))
        return 0.1 * x

    P.plms_sample(eps, DiffusionSchedule.linear(100), torch.ones((1, 3, 2)), 100, 25)
    assert calls == [75, 50, 50, 25, 0]


@pytest.mark.parametrize("steps", [1, 2, 3, 5, 10, 20])
def test_dpmpp_order3_matches(rng, steps):
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    ref = J.dpmpp_sample(j_eps, JNoiseSchedule(BETAS), jnp.asarray(x0), steps=steps, order=3)
    got = P.dpmpp_sample(t_eps, NoiseSchedule(BETAS), torch.from_numpy(x0), steps=steps, order=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_singlestep_orders_equal(order):
    for steps in range(1, 26):
        assert P.singlestep_orders(steps, order) == J.singlestep_orders(steps, order), steps
    with pytest.raises(ValueError):
        P.singlestep_orders(5, 4)


@pytest.mark.parametrize("steps", [1, 5, 20])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpmpp_singlestep_matches(rng, order, steps):
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    ref = J.dpmpp_singlestep_sample(j_eps, JNoiseSchedule(BETAS), jnp.asarray(x0), steps=steps, order=order)
    got = P.dpmpp_singlestep_sample(t_eps, NoiseSchedule(BETAS), torch.from_numpy(x0), steps=steps, order=order)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)


def test_singlestep_makes_steps_model_calls():
    calls = []

    def eps(x, t):
        calls.append(float(t[0]))
        return 0.1 * x

    P.dpmpp_singlestep_sample(eps, NoiseSchedule(BETAS), torch.ones((1, 3, 2)), steps=7, order=3)
    assert len(calls) == 7 and calls == sorted(calls, reverse=True)


@pytest.mark.parametrize("order", [2, 3])
def test_dpmpp_adaptive_matches(rng, order):
    """The accept/reject loop: the same final state, and the same number of
    model evaluations (so the same accepted and rejected steps)."""
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    ref = J.dpmpp_adaptive_sample(j_eps, JNoiseSchedule(BETAS), jnp.asarray(x0), order=order)
    calls = []

    def counted(x, t):
        calls.append(float(t[0]))
        return t_eps(x, t)

    got = P.dpmpp_adaptive_sample(counted, NoiseSchedule(BETAS), torch.from_numpy(x0), order=order)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)
    j_calls = []

    def j_counted(x, t):
        j_calls.append(float(t[0]))
        return j_eps(x, t)

    with jax.disable_jit():
        J.dpmpp_adaptive_sample(j_counted, JNoiseSchedule(BETAS), jnp.asarray(x0), order=order)
    assert len(calls) == len(j_calls) > 0
    np.testing.assert_allclose(calls, j_calls, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("steps", [1, 2, 3, 5, 20])
@pytest.mark.parametrize("order", [1, 2])
def test_unipc_vary_matches(rng, order, steps):
    j_eps, t_eps = _toy(rng)
    x0 = _x(rng)
    ref = J.unipc_vary_sample(j_eps, JNoiseSchedule(BETAS), jnp.asarray(x0), steps=steps, order=order)
    got = P.unipc_vary_sample(t_eps, NoiseSchedule(BETAS), torch.from_numpy(x0), steps=steps, order=order)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOY)


def test_inverse_lambda_matches():
    ref, got = JNoiseSchedule(BETAS), NoiseSchedule(BETAS)
    lam = np.linspace(-6.0, 6.0, 41).astype(np.float32)
    np.testing.assert_allclose(got.inverse_lambda(torch.from_numpy(lam)).numpy(),
                               np.asarray(ref.inverse_lambda(jnp.asarray(lam))), rtol=1e-6, atol=1e-7)


# -- GaussianDiffusion.sample for every method name ---------------------------


@pytest.fixture(scope="module")
def unit2mel():
    jsys = JUnit2MelSystem(JUnit2MelConfig(**U2M), seed=0)
    state = unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, jsys.params))
    return jsys, Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=state, device="cpu")


def _infer_inputs(seed=1):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((2, 13, 16)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    x0 = rng.standard_normal((2, 13, 6)).astype(np.float32)
    return units, spk, x0


@pytest.mark.parametrize("method,speedup,tol", [
    ("unipc", 10, UNET), ("dpm-solver", 10, UNET), ("dpm-solver-singlestep", 10, UNET),
    ("dpm-solver-adaptive", 10, ADAPTIVE), ("unipc-vary", 10, UNET), ("ddim", 5, UNET), ("pndm", 5, UNET),
])
def test_sample_matches_for_every_method(unit2mel, method, speedup, tol):
    jsys, sys_ = unit2mel
    units, spk, x0 = _infer_inputs()
    infer = jax.jit(lambda p, u, s, x: jsys.infer(u, jax.random.PRNGKey(0), spk_id=s, params=p, method=method,
                                                  infer_speedup=speedup, x_init=x))
    ref = infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(x0))
    got = sys_.infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(), method=method,
                     infer_speedup=speedup, x_init=torch.from_numpy(x0))
    assert got.shape == (2, 13, 6)
    if tol is ADAPTIVE:
        assert _adaptive_norm(got.numpy(), np.asarray(ref)) <= 2.0
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("method,speedup", [("ddpm", 10), (None, 10), ("unipc", 1)])
def test_sample_ddpm_cases_match_with_the_same_noise(unit2mel, monkeypatch, method, speedup):
    """DDPM over all k_step timesteps: method 'ddpm', None, or any method
    with infer_speedup <= 1."""
    jsys, sys_ = unit2mel
    units, spk, x0 = _infer_inputs()
    key = jax.random.PRNGKey(0)
    # GaussianDiffusion.sample splits twice (the x_T draw, then DDPM's key)
    _, ddpm_key = jax.random.split(jax.random.split(key)[0])
    T = 14  # 13 frames padded to the UNet grid
    noise = _SameNoise(np.random.default_rng(2), (2, T, 6), _SameNoise.ddpm_keys(ddpm_key, U2M["k_step"]))
    monkeypatch.setattr(jax.random, "normal", noise.jax_normal)
    monkeypatch.setattr(P, "_normal", noise.torch_normal)
    infer = jax.jit(lambda p, u, s, x: jsys.infer(u, key, spk_id=s, params=p, method=method,
                                                  infer_speedup=speedup, x_init=x))
    ref = infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(x0))
    got = sys_.infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(), method=method,
                     infer_speedup=speedup, x_init=torch.from_numpy(x0))
    assert noise.t == U2M["k_step"]
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **UNET)


def test_sample_draws_ddpm_noise_from_the_generator():
    """Without x_init the start and every DDPM step draw from the caller's
    generator: the same seed gives the same output, another seed another."""
    sys_ = Unit2MelSystem(Unit2MelConfig(**{**U2M, "timesteps": 8, "k_step": 8}), device="cpu")
    units, spk, _ = _infer_inputs()
    u, s = torch.from_numpy(units), torch.from_numpy(spk).long()

    def run(seed):
        return sys_.infer(u, torch.Generator().manual_seed(seed), spk_id=s, method="ddpm")

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
