"""The port's LoRA (`train/lora.py`) against the JAX package's, on the CPU.

On the tiny UNet of tests/test_lora.py, weights moved over with
`convert.py`: the same target set (keys and factor shapes), the merged
weights from the same factors within 1e-6, the zero-B identity, and the
gradients of a loss through `torch.func.functional_call(module,
lora_apply(state, lora), ...)`: they reach the factors only, and equal
`jax.grad` of the same loss in the factors within atol 1e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion import UNet1D as JUNet1D
from latent_diffusion_speech_tpu.models.diffusion import UNet1DConfig as JUNet1DConfig
from latent_diffusion_speech_tpu.train import lora as j_lora
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.train.lora import flax_path, lora_apply, lora_init, lora_param_count


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models: one intra-op thread (the parallel test run's workers
    would otherwise contend on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(in_channels=12, out_channels=4, block_out_channels=(8, 8), layers_per_block=1, n_heads=2)


@pytest.fixture(scope="module")
def pair():
    model = JUNet1D(JUNet1DConfig(**CFG))
    g = np.random.default_rng(1)
    # numpy draws on the init's shapes (an eager or jitted flax init costs seconds)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 12)), jnp.zeros((1,)))["params"]
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray((g.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]) or 1)).astype(np.float32)),
        shapes)
    # the factors with nonzero b, as after some training
    jl = {k: {"a": v["a"], "b": jnp.asarray(0.1 * g.standard_normal(v["b"].shape).astype(np.float32))}
          for k, v in j_lora.lora_init(params, jax.random.PRNGKey(1), rank=4).items()}
    module = UNet1D(UNet1DConfig(**CFG))
    module.load_state_dict(unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    lora = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in f.items()} for k, f in jl.items()}
    return model, params, jl, module, lora


def test_target_set_and_shapes_match_jax(pair):
    _, params, jl, module, _ = pair
    state = dict(module.named_parameters())
    mine = lora_init(state, torch.Generator().manual_seed(0), rank=4)
    assert mine.keys() == jl.keys() and len(mine) > 0
    assert all(k.endswith("/kernel") for k in mine)
    for k, f in mine.items():
        assert f["a"].shape == jl[k]["a"].shape and f["b"].shape == jl[k]["b"].shape, k
        assert not f["b"].any()
    assert lora_param_count(mine) == j_lora.lora_param_count(jl)
    # the zero-B factors leave every weight as it is
    for name, w in lora_apply(state, mine).items():
        assert torch.equal(w, state[name]), name
    assert flax_path("down_0_attn_0.attn1.to_q.weight") == "down_0_attn_0/attn1/to_q/kernel"


def test_merged_weights_match_jax(pair):
    _, params, jl, module, lora = pair
    merged = lora_apply(dict(module.named_parameters()), lora, scale=0.5)
    want = unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, j_lora.lora_apply(params, jl, scale=0.5)))
    assert merged.keys() == want.keys()
    changed = 0
    for name, w in merged.items():
        np.testing.assert_allclose(w.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
        changed += not torch.equal(w, dict(module.named_parameters())[name])
    assert changed == len(lora)


def test_gradients_reach_the_factors_only_and_match_jax(pair, rng):
    model, params, jl, module, lora = pair
    x = rng.standard_normal((2, 16, 12)).astype(np.float32)
    t = np.array([3.0, 7.0], np.float32)

    def j_loss(factors):
        return jnp.mean(model.apply({"params": j_lora.lora_apply(params, factors)}, x, t) ** 2)

    j_grads = jax.jit(jax.grad(j_loss))(jl)
    factors = {k: {n: v.clone().requires_grad_() for n, v in f.items()} for k, f in lora.items()}
    state = {n: p.detach() for n, p in module.named_parameters()}  # the base weights frozen
    out = torch.func.functional_call(module, lora_apply(state, factors), (torch.from_numpy(x), torch.from_numpy(t)))
    (out ** 2).mean().backward()
    assert all(p.grad is None for p in module.parameters())
    for k, f in factors.items():
        for n, v in f.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(j_grads[k][n]), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{k}.{n}")
    assert any(f["b"].grad.abs().max() > 0 for f in factors.values())
